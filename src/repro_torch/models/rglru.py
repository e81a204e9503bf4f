"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of ``repro/models/rglru.py``:

    y = W_out · ( GeLU(W_gate x) ⊙ RG-LRU( Conv1D_w( W_in x ) ) )

    r_t = σ(W_a x_t + b_a),  i_t = σ(W_x x_t + b_x)
    a_t = a^{c·r_t},  a = σ(Λ)  (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The recurrence is a first-order diagonal one, so it runs as an associative
scan over time.  torch has none; ``associative_scan`` below is JAX's
odd/even recursion (``jax.lax.associative_scan``) written out: log-depth, a
few tensor ops a level, the same pairs combined in the same order, so the
same roundings.  Decode runs the block at T = 1 with the (width − 1)-token
conv tail and the f32 state ``h`` carried in an :class:`RGLRUState`.

In a partitioned train step (DTensors, autograd recording;
``launch/dryrun.py``) the causal conv and the recurrence run on each
rank's block under ``local_map``, their explicit sharding rule: the rows on
the data axes and the recurrence width on the tensor axis ``model``.  The
conv takes its block of the width as it is; the recurrence takes the conv's
output whole over ``model`` (one all-gather) for its gates' products, whose
weights' column blocks give its block of the gates, so the scan and its
backward stay on the rank.  The forward-only steps (prefill, decode) keep
DTensor's own rules.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh

from .params import const, normal, zeros

_C_EXPONENT = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) recurrence state, f32
    conv_tail: torch.Tensor  # (B, width − 1, W) conv1d history


def rglru_init(gen, d: int, width: int, conv_width: int = 4, dtype=torch.float32):
    w = width
    dev = gen.device
    # Λ so that a ∈ (0.9, 0.999), as in the paper.
    lam = torch.log(torch.exp(torch.linspace(4.0, 9.0, w, device=dev)) - 1.0) / _C_EXPONENT
    return {
        "w_in": normal(gen, (d, w), 1.0, dtype, ("embed", "mlp")),
        "w_gate": normal(gen, (d, w), 1.0, dtype, ("embed", "mlp")),
        "w_out": normal(gen, (w, d), 1.0, dtype, ("mlp", "embed")),
        "conv_w": normal(gen, (conv_width, w), 1.0, dtype, (None, "mlp")),
        "wa": normal(gen, (w, w), 1.0, dtype, ("mlp", "mlp_out")),
        "ba": zeros((w,), dtype, dev, ("mlp",)),
        "wx": normal(gen, (w, w), 1.0, dtype, ("mlp", "mlp_out")),
        "bx": zeros((w,), dtype, dev, ("mlp",)),
        "lam": const(lam.to(dtype), ("mlp",)),
    }


def _conv1d_causal(p, x: torch.Tensor, tail: Optional[torch.Tensor], compute_dtype):
    """Depthwise causal conv along time.  x: (B, T, W).  Returns the output
    and the new tail (the last width − 1 inputs, the old tail included)."""
    w = p["conv_w"].to(compute_dtype)              # (K, W)
    kw = w.shape[0]
    b, t, width = x.shape
    if tail is None:
        tail = torch.zeros((b, kw - 1, width), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)               # (B, T + K − 1, W)
    out = torch.zeros_like(x)
    for i in range(kw):
        out = out + xp[:, i:i + t, :] * w[i]
    return out, xp[:, -(kw - 1):, :]


def _rglru_gates(p, u: torch.Tensor, u_block: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t and the gated input, f32.  ``u_block``: the columns of ``u`` that
    the gates' weights give (their column blocks, in a partitioned step;
    default: all of ``u``)."""
    uf = u.float()
    r = torch.sigmoid(sh.reduce_partial(torch.matmul(uf, p["wa"].float()), -1) + p["ba"].float())
    i = torch.sigmoid(sh.reduce_partial(torch.matmul(uf, p["wx"].float()), -1) + p["bx"].float())
    lam = p["lam"].float()
    log_a_base = -_C_EXPONENT * torch.logaddexp(lam, torch.zeros_like(lam))   # softplus
    log_a = log_a_base * r                          # (B, T, W), ≤ 0
    a = torch.exp(log_a)
    xin = uf if u_block is None else u_block.float()
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xin)
    return a, gated


def _slice(e: torch.Tensor, dim: int, start: int, stop: Optional[int] = None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * e.ndim
    idx[dim] = slice(start, stop, step)
    return e[tuple(idx)]


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int = 1) -> list:
    """Inclusive scan of ``fn`` over ``dim`` of every tensor in ``elems``, by
    the recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the pairs, combine the scanned pairs with the elements at even
    positions, interleave."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)
    reduced = fn([_slice(e, dim, 0, n - 1, 2) for e in elems],
                 [_slice(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    rest = [_slice(e, dim, 2, None, 2) for e in elems]
    even = fn([_slice(e, dim, 0, -1) for e in odd] if n % 2 == 0 else odd, rest)
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        _slice(full, dim, 0, 1).copy_(_slice(e, dim, 0, 1))
        _slice(full, dim, 2, None, 2).copy_(ev)
        _slice(full, dim, 1, None, 2).copy_(od)
        out.append(full)
    return out


def _combine(left, right):
    a1, x1 = left
    a2, x2 = right
    return [a1 * a2, x2 + a2 * x1]


def rglru_scan(p, u: torch.Tensor, h0: Optional[torch.Tensor] = None,
               u_block: Optional[torch.Tensor] = None):
    """Full-sequence RG-LRU.  u: (B, T, W) → (h_seq in u's dtype, h_T f32);
    with ``u_block`` (see ``_rglru_gates``) the recurrence of its columns."""
    a, x = _rglru_gates(p, u, u_block)
    if h0 is not None:
        # The carried state enters as a virtual step-0 contribution.
        x = torch.cat([x[:, :1] + a[:, :1] * h0.float()[:, None], x[:, 1:]], dim=1)
    _, h = associative_scan(_combine, [a, x], dim=1)
    return h.to(u.dtype), h[:, -1, :]


def rglru_block_apply(p, x: torch.Tensor, state: Optional[RGLRUState] = None,
                      compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, RGLRUState]:
    """The Griffin recurrent block (proj → conv → RG-LRU → gate → out)."""
    xc = x.to(compute_dtype)
    u = torch.matmul(xc, p["w_in"].to(compute_dtype))
    gate = F.gelu(torch.matmul(xc, p["w_gate"].to(compute_dtype)), approximate="tanh")
    if sh.is_dtensor(u) and u.requires_grad:
        h_seq, h_last, new_tail = _recurrence_partitioned(p, u, compute_dtype)
    else:
        h_seq, h_last, new_tail = _recurrence(p, u, state, compute_dtype)
    y = h_seq.to(compute_dtype) * gate
    out = torch.matmul(y, p["w_out"].to(compute_dtype))
    return out, RGLRUState(h=h_last, conv_tail=new_tail)


def _recurrence(p, u: torch.Tensor, state: Optional[RGLRUState], compute_dtype):
    """The causal conv and the RG-LRU: ``(h_seq, h_T, conv tail)``."""
    u, new_tail = _conv1d_causal(p, u, state.conv_tail if state else None, compute_dtype)
    h_seq, h_last = rglru_scan(p, u, h0=state.h if state else None)
    return h_seq, h_last, new_tail


def _recurrence_partitioned(p, u, compute_dtype):
    """``_recurrence`` over DTensors in a train step (no carried state), by
    the rule of the module docstring."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = u.device_mesh
    dp, model = sh.mesh_dims(dmesh)
    b, _, w = u.shape
    if b % math.prod(dmesh.size(i) for i in dp):
        dp = []
    width = [model] if model is not None and w % dmesh.size(model) == 0 else []
    placed = lambda on_dp, on_model: sh.placed(dmesh.ndim, (dp, on_dp), (width, on_model))

    rows = placed(Shard(0), Shard(2))
    conv = lambda u, conv_w: _conv1d_causal({"conv_w": conv_w}, u, None, compute_dtype)
    u, new_tail = local_map(
        conv, out_placements=(rows, rows), in_placements=(rows, placed(Replicate(), Shard(1))),
        in_grad_placements=(rows, placed(Partial(), Shard(1))),
        device_mesh=dmesh, redistribute_inputs=True)(u, p["conv_w"])

    def scan(u, wa, ba, wx, bx, lam):
        w0 = dmesh.get_local_rank(model) * lam.shape[0] if width else 0
        gates = {"wa": wa, "ba": ba, "wx": wx, "bx": bx, "lam": lam}
        return rglru_scan(gates, u, u_block=u[..., w0:w0 + lam.shape[0]])

    whole = placed(Shard(0), Replicate())
    cols, vec = placed(Replicate(), Shard(1)), placed(Replicate(), Shard(0))
    cols_grad, vec_grad = placed(Partial(), Shard(1)), placed(Partial(), Shard(0))
    h_seq, h_last = local_map(
        scan, out_placements=(rows, placed(Shard(0), Shard(1))),
        in_placements=(whole, cols, vec, cols, vec, vec),
        in_grad_placements=(placed(Shard(0), Partial()), cols_grad, vec_grad, cols_grad,
                            vec_grad, vec_grad),
        device_mesh=dmesh, redistribute_inputs=True)(
            u.redistribute(dmesh, whole), p["wa"], p["ba"], p["wx"], p["bx"], p["lam"])
    return h_seq, h_last, new_tail


def rglru_init_state(batch: int, width: int, conv_width: int = 4, dtype=torch.bfloat16,
                     device="cpu") -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, width), dtype=torch.float32, device=device),
        conv_tail=torch.zeros((batch, conv_width - 1, width), dtype=dtype, device=device),
    )


def rglru_decode_step(p, x: torch.Tensor, state: RGLRUState,
                      compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, RGLRUState]:
    """One-token step (T = 1), O(1) in context length."""
    return rglru_block_apply(p, x, state=state, compute_dtype=compute_dtype)
