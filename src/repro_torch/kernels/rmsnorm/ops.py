"""Dispatch for the fused RMSNorm.

  impl="cuda"       the hand-written kernel (kernel.py, csrc/rmsnorm.cu); on
                    CPU tensors the plain version.  The reference's "pallas".
  impl="reference"  the plain PyTorch version (ref.py).

The port's ``models.layers.norm_apply`` calls this with ``impl="cuda"``
(the reference model computes the same function in plain jnp).  Whenever
autograd records (grad mode on and ``x`` or ``scale`` requiring grad),
``"cuda"`` runs through :class:`RMSNorm`: the same forward, and ``dx`` and
``dscale`` written out in f32 plain PyTorch.  The reference differentiates
its plain jnp (``layers.py:28-38``) and has no backward kernel.

Over DTensors (a partitioned step) the op runs on each rank's rows under
``local_map``, its explicit sharding rule: ``x`` whole along its last dim,
``scale`` replicated, the output placed as ``x``, and ``scale``'s gradient
the ranks' partial sums wherever ``x``'s rows are split.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import rmsnorm_ref

IMPLS = ("cuda", "reference")


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel on the card, the plain version on CPU tensors, the
    kernel's output shape on meta tensors (the dry-run)."""
    if x.device.type == "meta":
        shape = x.shape
        return _kernel.rmsnorm_meta(x.reshape(-1, shape[-1]).contiguous(),
                                    scale.contiguous(), eps).reshape(shape)
    if x.device.type != "cpu":
        shape = x.shape
        y = _kernel.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                                 scale.contiguous(), eps)
        return y.reshape(shape)
    return rmsnorm_ref(x, scale, eps)


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, eps: float, dy: torch.Tensor):
    """``(dx, dscale)`` of ``y = x · r · scale``, ``r = rsqrt(mean(x²) + eps)``,
    in f32, cast to the dtypes of ``x`` and ``scale``:
    ``dx = r · (g − r² · x · mean(g · x))`` with ``g = dy · scale``, and
    ``dscale = Σ_rows dy · x · r``."""
    xf, w, dyf = x.float(), scale.float(), dy.float()
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    g = dyf * w
    dx = r * (g - (r * r) * xf * torch.mean(g * xf, dim=-1, keepdim=True))
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    """``RMSNorm.apply(x, scale, eps)``: the kernel's forward (the plain
    version on CPU tensors) with the backward above; saves ``x`` and
    ``scale``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, ctx.eps, dy)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            impl: str = "cuda") -> torch.Tensor:
    """RMSNorm over the last axis of ``x (..., D)`` with ``scale (D,)``; the
    output has ``x``'s dtype and shape."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rmsnorm impl {impl!r}; expected {IMPLS}")
    if impl == "reference":
        return rmsnorm_ref(x, scale, eps)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _partitioned(x, scale, eps, impl)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


def _partitioned(x, scale, eps: float, impl: str):
    """``rmsnorm`` of a DTensor by the rule of the module docstring."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = x.device_mesh
    last = x.ndim - 1
    x_pl = tuple(Replicate() if p.is_partial() or p == Shard(last) else p
                 for p in x.placements)
    whole = (Replicate(),) * dmesh.ndim
    scale_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in x_pl)
    return local_map(lambda x, s: rmsnorm(x, s, eps, impl), out_placements=(x_pl,),
                     in_placements=(x_pl, whole), in_grad_placements=(x_pl, scale_grad),
                     device_mesh=dmesh, redistribute_inputs=True)(x, scale)
