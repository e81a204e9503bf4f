"""Shared neural layers: norms, projections, GLU MLPs, RoPE, embeddings.

Port of ``repro/models/layers.py``: init functions build ``Param`` trees
with the reference's logical axes (``params.py``), apply functions take the
value trees.  Every product casts to the compute dtype (bf16 by default) with
f32 normalisation statistics, as the reference.  Products are
``torch.matmul``; the reference leaves them to XLA.

``norm_apply(kind="rmsnorm")`` runs the port's RMSNorm kernel
(``kernels/rmsnorm``, ``impl="cuda"``): on the card the hand-written
kernel, on CPU tensors its plain version.  The reference computes the same
function in plain jnp (``layers.py:28-38``), which XLA fuses; eager
PyTorch would launch about seven kernels for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.kernels.rmsnorm import ops as rms_ops

from .params import normal, ones, zeros


# ------------------------------------------------------------------- norms

def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32, device="cpu"):
    if kind == "layernorm":
        return {"scale": ones((d,), dtype, device, ("embed",)),
                "bias": zeros((d,), dtype, device, ("embed",))}
    return {"scale": ones((d,), dtype, device, ("embed",))}


def norm_apply(p, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    if kind == "layernorm":
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
        return y.to(x.dtype)
    return rms_ops.rmsnorm(x, p["scale"], eps, impl="cuda")


# ------------------------------------------------------------------ linear

def linear_init(gen, din: int, dout: int, axes, dtype=torch.float32, scale=1.0):
    return {"w": normal(gen, (din, dout), scale, dtype, axes)}


def linear_apply(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))


# ------------------------------------------------------------------- MLPs

def glu_mlp_init(gen, d: int, f: int, dtype=torch.float32, activation: str = "swiglu"):
    # The reference splits its key three ways (gate, up, out); the port draws
    # in that order from one generator.
    gate = normal(gen, (d, f), 1.0, dtype, ("embed", "mlp"))
    p = {
        "wi_up": normal(gen, (d, f), 1.0, dtype, ("embed", "mlp")),
        "wo": normal(gen, (f, d), 1.0, dtype, ("mlp", "embed")),
    }
    if activation in ("swiglu", "geglu"):
        p["wi_gate"] = gate
    return p


def glu_mlp_apply(p, x: torch.Tensor, activation: str = "swiglu",
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    xc = x.to(compute_dtype)
    up = torch.matmul(xc, p["wi_up"].to(compute_dtype))
    if activation in ("swiglu", "geglu"):
        gate = torch.matmul(xc, p["wi_gate"].to(compute_dtype))
        act = F.gelu(gate, approximate="tanh") if activation == "geglu" else F.silu(gate)
        h = act * up
    else:  # plain gelu/relu two-matrix MLP (whisper)
        h = F.gelu(up, approximate="tanh") if activation == "gelu" else F.relu(up)
    return torch.matmul(h, p["wo"].to(compute_dtype))


# -------------------------------------------------------------------- RoPE

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., T, H, Dh); positions: (..., T) absolute.
    Frequencies in f32, halves concatenated (not interleaved)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freq               # (..., T, half)
    angles = angles[..., :, None, :]                              # (..., T, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- embeddings

def embedding_init(gen, vocab: int, d: int, dtype=torch.float32):
    # std = 1/√d: the √d multiplier at the input restores unit variance.
    return {"table": normal(gen, (vocab, d), (vocab / d) ** 0.5, dtype, ("vocab", "embed"))}


def embed_apply(p, tokens: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-take,
    # without casting the whole table.
    if sh.is_dtensor(p["table"]):
        return _embed_partitioned(p["table"], tokens).to(compute_dtype)
    return p["table"][tokens.long()].to(compute_dtype)


def _embed_partitioned(table, tokens):
    """The lookup over DTensors, its explicit rule (``local_map``): each
    rank looks up its batch rows in its block of the vocabulary where the
    tensor axis ``model`` divides it (a row outside the block reads zero),
    the sum over ``model`` left pending (``Partial``); the table's gradient
    is the ranks' partial sums over the batch split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    dp, model = sh.mesh_dims(mesh)
    vocab = model is not None and mesh.size(model) > 1 and table.shape[0] % mesh.size(model) == 0
    batch = tokens.shape[0] % math.prod(mesh.size(i) for i in dp) == 0
    tok_pl = [Replicate()] * mesh.ndim
    tab_pl = [Replicate()] * mesh.ndim
    for i in dp:
        tok_pl[i] = Shard(0) if batch else Replicate()
    if vocab:
        tab_pl[model] = Shard(0)
    out_pl = list(tok_pl)
    if vocab:
        out_pl[model] = Partial()
    tab_grad = [Partial() if batch and i in dp else p for i, p in enumerate(tab_pl)]

    def local(table, tokens):
        ids = tokens.long()
        if not vocab:
            return table[ids]
        at = ids - mesh.get_local_rank(model) * table.shape[0]
        here = (at >= 0) & (at < table.shape[0])
        return torch.where(here[..., None], table[torch.where(here, at, 0)], 0.0)

    return local_map(local, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(tab_pl), tuple(tok_pl)),
                     in_grad_placements=(tuple(tab_grad), tuple(tok_pl)), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def logits_init(gen, d: int, vocab: int, dtype=torch.float32):
    return {"w": normal(gen, (d, vocab), 1.0, dtype, ("embed", "vocab"))}


def logits_apply(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))


def tied_logits_apply(embed_params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    table = embed_params["table"].to(compute_dtype)
    return torch.matmul(x.to(compute_dtype), table.t())
