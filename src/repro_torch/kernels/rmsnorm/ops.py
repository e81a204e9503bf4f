"""Dispatch for the fused RMSNorm.

  impl="cuda"       the hand-written kernel (kernel.py, csrc/rmsnorm.cu); on
                    CPU tensors the plain version.  The reference's "pallas".
  impl="reference"  the plain PyTorch version (ref.py).

The port's ``models.layers.norm_apply`` calls this with ``impl="cuda"``
(the reference model computes the same function in plain jnp).
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import rmsnorm_ref

IMPLS = ("cuda", "reference")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            impl: str = "cuda") -> torch.Tensor:
    """RMSNorm over the last axis of ``x (..., D)`` with ``scale (D,)``; the
    output has ``x``'s dtype and shape."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rmsnorm impl {impl!r}; expected {IMPLS}")
    if impl == "cuda" and x.device.type != "cpu":
        shape = x.shape
        y = _kernel.rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                                 scale.contiguous(), eps)
        return y.reshape(shape)
    return rmsnorm_ref(x, scale, eps)
