"""RWKV-6 "Finch" block: attention-free time mixing with data-dependent
per-channel decay [arXiv:2404.05892].

Port of ``repro/models/rwkv6.py``.  Per head, with state S ∈ R^{Dh×Dh}:

    S_t   = diag(w_t) · S_{t−1} + k_tᵀ v_t
    out_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t)

with decay w_t = exp(−exp(w0 + LoRA(x̃_t))), clamped at e^{−DECAY_CLAMP}
a step, token-shift interpolation x̃ and a gated output; the channel mix is
the squared-ReLU two-matrix FFN.

Two paths, as in the reference: ``sequential`` (the exact token recurrence,
a Python loop over T; decode runs it at T = 1) and ``chunked`` (prefill:
within a chunk a masked quadratic form, across chunks only the state is
carried, a Python loop over T / chunk).  The chunked form factors the
pairwise decay e^{L_t − L_j} into e^{L_t} · e^{−L_j}, which reach e^{±35}
at chunk 64: its f32 products must stay true f32, so they run with TF32
switched off whatever the caller set (``_true_f32``).

Over DTensors (a partitioned step, ``launch/dryrun.py``) the time mix's
per-head part (the heads' views, the recurrence or the chunk scan, the
state) runs on each rank's block under ``local_map``, its explicit sharding
rule: the rows on the data axes and the heads on the tensor axis ``model``
where they divide it.  DTensor sees only the projections into and out of it
and the channel mix, whose products keep DTensor's rules.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh

from .layers import norm_apply, norm_init
from .params import normal, zeros

# Per-step log-decay floor (the reference's DECAY_CLAMP, ``rwkv6.py:45``).
DECAY_CLAMP = 0.55


@contextlib.contextmanager
def _true_f32():
    """f32 matmuls in f32 on the card (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def rwkv6_init(gen, d: int, n_heads: int, head_dim: int, lora_rank: int = 64,
               dtype=torch.float32):
    h, dh = n_heads, head_dim
    assert h * dh == d, (h, dh, d)
    dev = gen.device
    return {
        "mu": zeros((5, d), dtype, dev, (None, "embed")),  # token-shift mixes r, k, v, g, w
        "wr": normal(gen, (d, d), 1.0, dtype, ("embed", "heads_flat")),
        "wk": normal(gen, (d, d), 1.0, dtype, ("embed", "heads_flat")),
        "wv": normal(gen, (d, d), 1.0, dtype, ("embed", "heads_flat")),
        "wg": normal(gen, (d, d), 1.0, dtype, ("embed", "heads_flat")),
        "wo": normal(gen, (d, d), 1.0, dtype, ("heads_flat", "embed")),
        "w0": zeros((d,), dtype, dev, ("embed",)),          # base log-log decay
        "w_lora_a": normal(gen, (d, lora_rank), 1.0, dtype, ("embed", None)),
        "w_lora_b": zeros((lora_rank, d), dtype, dev, (None, "embed")),
        "u": zeros((h, dh), dtype, dev, ("heads", "head_dim")),  # bonus
        "ln_x": norm_init(d, "layernorm", dtype, dev),
    }


def _mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Token shift: lerp(x_{t−1}, x_t, μ)."""
    return x_prev + mu * (x - x_prev)


def _project(p, x: torch.Tensor, x_prev: torch.Tensor, compute_dtype):
    mu = p["mu"].to(compute_dtype)
    xr, xk, xv, xg, xw = (_mix(x, x_prev, mu[i]) for i in range(5))
    r = torch.matmul(xr, p["wr"].to(compute_dtype))
    k = torch.matmul(xk, p["wk"].to(compute_dtype))
    v = torch.matmul(xv, p["wv"].to(compute_dtype))
    g = torch.matmul(xg, p["wg"].to(compute_dtype))
    # Data-dependent decay through the LoRA, in f32.
    lora = torch.tanh(torch.matmul(xw.float(), p["w_lora_a"].float()))
    logw = p["w0"].float() + torch.matmul(lora, p["w_lora_b"].float())
    # w = exp(−exp(logw)) ∈ (0, 1); log_decay = −exp(logw) clamped at −DECAY_CLAMP.
    log_decay = torch.clamp(-torch.exp(logw), min=-DECAY_CLAMP)
    return r, k, v, g, log_decay


def _heads(x: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], h, dh)


def rwkv6_time_mix(
    p,
    x: torch.Tensor,                # (B, T, D)
    n_heads: int,
    head_dim: int,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (prev_x (B, D), S (B, H, Dh, Dh))
    chunk: int = 64,
    impl: str = "chunked",
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence time mixing.  Returns ``(out, (last_x, last_state))``."""
    if impl not in ("chunked", "sequential"):
        raise ValueError(f"unknown rwkv6 impl {impl!r}; expected 'chunked' or 'sequential'")
    b, t, d = x.shape
    h, dh = n_heads, head_dim
    xc = x.to(compute_dtype)
    if state is None and sh.is_dtensor(xc):
        # Each rank's blocks of the zero states (the WKV state's is made in
        # its ``local_map``).
        prev_x, s0 = torch.zeros_like(xc[:, 0]), None
    elif state is None:
        prev_x = torch.zeros((b, d), dtype=compute_dtype, device=x.device)
        s0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    else:
        prev_x, s0 = state[0].to(compute_dtype), state[1]

    with _true_f32():
        x_shift = torch.cat([prev_x[:, None, :], xc[:, :-1, :]], dim=1)
        r, k, v, g, log_decay = _project(p, xc, x_shift, compute_dtype)
        if sh.is_dtensor(r):
            out, s_last = _wkv_partitioned(r, k, v, log_decay, p["u"], s0, dh, impl, chunk)
        else:
            out, s_last = _wkv(r, k, v, log_decay, p["u"], s0, dh, impl, chunk)

    out = norm_apply(p["ln_x"], out.reshape(b, t, d).to(compute_dtype), "layernorm")
    out = out * F.silu(g.to(compute_dtype))
    y = torch.matmul(out, p["wo"].to(compute_dtype))
    return y, (xc[:, -1, :], s_last)


def _wkv(r, k, v, log_decay, u, s0, dh: int, impl: str, chunk: int):
    """The per-head part: (B, T, H·Dh) projections → (B, T, H, Dh) output
    and the last state (B, H, Dh, Dh)."""
    h = r.shape[-1] // dh
    r, k, v = (_heads(a.float(), h, dh) for a in (r, k, v))   # (B, T, H, Dh)
    logw = _heads(log_decay, h, dh)                            # ≤ 0
    u = u.float()                                              # (H, Dh)
    if impl == "sequential":
        return _wkv_sequential(r, k, v, logw, u, s0)
    return _wkv_chunked(r, k, v, logw, u, s0, chunk)


def _wkv_partitioned(r, k, v, log_decay, u, s0, dh: int, impl: str, chunk: int):
    """``_wkv`` over DTensors on each rank's rows and heads (``local_map``);
    ``s0`` is the cache's state or the zeros of a plain tensor (made on each
    rank at its block's shape)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = r.device_mesh
    dp, model = sh.mesh_dims(dmesh)
    b, t, d = r.shape
    if b % math.prod(dmesh.size(i) for i in dp):
        dp = []
    heads = [model] if model is not None and (d // dh) % dmesh.size(model) == 0 else []
    placed = lambda dim, on_dp: sh.placed(dmesh.ndim, (dp, on_dp), (heads, Shard(dim)))
    cached = sh.is_dtensor(s0)

    def local(r, k, v, log_decay, u, *s0):
        s0 = s0[0] if s0 else torch.zeros(r.shape[:1] + (r.shape[-1] // dh, dh, dh),
                                          dtype=torch.float32, device=r.device)
        out, s_last = _wkv(r, k, v, log_decay, u, s0, dh, impl, chunk)
        return out.flatten(2), s_last

    rows = placed(2, Shard(0))
    state = placed(1, Shard(0))
    u_pl = placed(0, Replicate())
    return local_map(
        local, out_placements=(rows, state),
        in_placements=(rows,) * 4 + (u_pl,) + ((state,) if cached else ()),
        in_grad_placements=(rows,) * 4 + (placed(0, Partial()),) + ((state,) if cached else ()),
        device_mesh=dmesh, redistribute_inputs=True)(r, k, v, log_decay, u,
                                                     *((s0,) if cached else ()))


def _wkv_sequential(r, k, v, logw, u, s0):
    """The exact token recurrence."""
    s = s0
    outs = []
    for i in range(r.shape[1]):
        r_t, k_t, v_t, lw_t = r[:, i], k[:, i], v[:, i], logw[:, i]   # (B, H, Dh)
        kv = k_t[..., :, None] * v_t[..., None, :]                      # (B, H, Dh, Dh)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s + u[None, :, :, None] * kv))
        s = torch.exp(lw_t)[..., None] * s + kv
    return torch.stack(outs, dim=1), s                                  # (B, T, H, Dh)


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """Block-parallel WKV: intra-chunk masked quadratic + cross-chunk state.

    Within a chunk, with cumulative log-decay L_i = Σ_{m≤i} lw_m:
      out_i = (r_i ⊙ e^{L_{i−1}}) S + Σ_{j<i} (r_i ⊙ e^{L_{i−1}−L_j}) k_j · v_j
              + (r_i ⊙ u ⊙ k_i) v_i
    """
    b, t, h, dh = r.shape
    c = chunk
    pad = (-t) % c
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    n = (t + pad) // c
    rc, kc, vc, lw = (a.reshape(b, n, c, h, dh) for a in (r, k, v, logw))

    lcum = torch.cumsum(lw, dim=2)                      # inclusive L_i
    lexcl = lcum - lw                                   # exclusive L_{i−1}
    ltot = lcum[:, :, -1:]                              # (B, n, 1, H, Dh)

    r_dec = rc * torch.exp(lexcl)                       # r_i ⊙ e^{L_{i−1}}
    k_dec = kc * torch.exp(-lcum)                       # k_j ⊙ e^{−L_j}
    scores = torch.einsum("bnchd,bnmhd->bnhcm", r_dec, k_dec)
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)   # strictly lower
    scores = torch.where(tri, scores, 0.0)
    diag = torch.einsum("bnchd,hd,bnchd->bnch", rc, u, kc)   # bonus (r_i ⊙ u ⊙ k_i)
    intra = torch.einsum("bnhcm,bnmhd->bnchd", scores, vc) + diag[..., None] * vc

    k_scaled = kc * torch.exp(ltot - lcum)              # k_j ⊙ e^{L_C − L_j}
    decay_tot = torch.exp(ltot[:, :, 0])                # (B, n, H, Dh)
    s = s0
    out_state = []
    for i in range(n):
        out_state.append(torch.einsum("bchd,bhde->bche", r_dec[:, i], s))
        s = decay_tot[:, i][..., None] * s + torch.einsum("bchd,bche->bhde", k_scaled[:, i],
                                                          vc[:, i])
    out = intra + torch.stack(out_state, dim=1)
    return out.reshape(b, n * c, h, dh)[:, :t], s


def rwkv6_decode_step(p, x, state, n_heads, head_dim, compute_dtype=torch.bfloat16):
    """One-token step: x (B, 1, D); state = (prev_x, S)."""
    return rwkv6_time_mix(p, x, n_heads, head_dim, state=state, impl="sequential",
                          compute_dtype=compute_dtype)


# ----------------------------------------------------------- channel mix

def rwkv6_channel_init(gen, d: int, f: int, dtype=torch.float32):
    dev = gen.device
    return {
        "mu": zeros((2, d), dtype, dev, (None, "embed")),
        "wk": normal(gen, (d, f), 1.0, dtype, ("embed", "mlp")),
        "wv": normal(gen, (f, d), 1.0, dtype, ("mlp", "embed")),
        "wr": zeros((d, d), dtype, dev, ("embed", "embed_out")),
    }


def rwkv6_channel_mix(p, x: torch.Tensor, state: Optional[torch.Tensor] = None,
                      compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, d = x.shape
    xc = x.to(compute_dtype)
    if state is not None:
        prev = state.to(compute_dtype)
    elif sh.is_dtensor(xc):
        prev = torch.zeros_like(xc[:, 0])
    else:
        prev = torch.zeros((b, d), dtype=compute_dtype, device=x.device)
    x_shift = torch.cat([prev[:, None, :], xc[:, :-1, :]], dim=1)
    mu = p["mu"].to(compute_dtype)
    xk = _mix(xc, x_shift, mu[0])
    xr = _mix(xc, x_shift, mu[1])
    k = torch.matmul(xk, p["wk"].to(compute_dtype))
    v = torch.matmul(torch.square(F.relu(k)), p["wv"].to(compute_dtype))
    # Over DTensors the gate's gradient comes back from ``r * v`` unreduced
    # (``v`` is a partial sum): whole but for the batch split before the
    # product's backward flattens it.
    r = torch.sigmoid(sh.grad_split_on(torch.matmul(xr, p["wr"].to(compute_dtype)), 0))
    return r * v, xc[:, -1, :]
