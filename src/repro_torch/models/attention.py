"""Attention blocks: GQA/MQA with RoPE, full / sliding-window / prefix-LM
masking, flash attention for prefill, and a KV-cache decode step.

Port of ``repro/models/attention.py``.

* Prefill (``attention_apply``) calls ``kernels.flash_attention``:
  ``impl="cuda"`` is the hand-written kernel (the reference's ``"pallas"``),
  ``"chunked"`` the plain online softmax, ``"reference"`` the O(T²) oracle.
  The ``(B, T, H, Dh)`` projections go to the kernel as ``(B, H, T, Dh)``
  views, without a copy.
* Decode (``attention_decode``) is a masked product over the cache in f32,
  plain PyTorch as in the reference: with one query token the scores are
  ``(B, H, 1, S)``, bound by bandwidth, no flash needed.  It writes the new
  K/V into the cache **in place** (the reference returns a new cache from
  ``dynamic_update_slice``) and returns the same dict.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

from .layers import rope
from .params import normal

NEG_INF = -1e30


def attention_init(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.float32):
    return {
        "wq": normal(gen, (d, n_heads, head_dim), 1.0, dtype, ("embed", "heads", "head_dim")),
        "wk": normal(gen, (d, n_kv, head_dim), 1.0, dtype, ("embed", "kv", "head_dim")),
        "wv": normal(gen, (d, n_kv, head_dim), 1.0, dtype, ("embed", "kv", "head_dim")),
        "wo": normal(gen, (n_heads, head_dim, d), 1.0, dtype, ("heads", "head_dim", "embed")),
    }


def proj_heads(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype).reshape(d, h * k))
    return y.reshape(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, compute_dtype) -> torch.Tensor:
    """einsum("bthk,hkd->btd") with ``out`` (B, T, H, Dh)."""
    h, k, d = wo.shape
    flat = out.to(compute_dtype).reshape(*out.shape[:-2], h * k)
    return torch.matmul(flat, wo.to(compute_dtype).reshape(h * k, d))


def _project_qkv(p, x: torch.Tensor, positions: Optional[torch.Tensor], theta: float,
                 compute_dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = proj_heads(x, p["wq"], compute_dtype)
    k = proj_heads(x, p["wk"], compute_dtype)
    v = proj_heads(x, p["wv"], compute_dtype)
    if positions is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def attention_apply(
    p,
    x: torch.Tensor,                # (B, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,            # prefix-LM: first P positions bidirectional
    rope_theta: float = 10000.0,
    impl: str = "chunked",
    block_q: int = 512,
    block_k: int = 1024,
    compute_dtype=torch.bfloat16,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attention
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, t, d = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    use_rope = kv_override is None  # cross-attention is position-free here
    q, k, v = _project_qkv(p, x, positions if use_rope else None, rope_theta, compute_dtype)
    if kv_override is not None:
        k, v = kv_override
        causal = False

    out = fa_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),   # (B, H, T, Dh) views
        causal=causal, window=window, prefix_len=prefix_len,
        impl=impl, block_q=block_q, block_k=block_k,
    )
    return _out_proj(out.transpose(1, 2), p["wo"], compute_dtype)


# ------------------------------------------------------------------ decode

def init_kv_cache(batch: int, n_kv: int, max_seq: int, head_dim: int,
                  dtype=torch.bfloat16, device="cpu"):
    return {
        "k": torch.zeros((batch, n_kv, max_seq, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, n_kv, max_seq, head_dim), dtype=dtype, device=device),
    }


def attention_decode(
    p,
    cache,
    x: torch.Tensor,          # (B, 1, D)
    pos: int,                 # current absolute position
    *,
    window: Optional[int] = None,
    prefix_len: int = 0,
    rope_theta: float = 10000.0,
    compute_dtype=torch.bfloat16,
    cross: bool = False,      # cross-attention: cache holds encoder KV, no update
    ring: bool = False,       # sliding-window ring buffer (cache len == window)
) -> Tuple[torch.Tensor, dict]:
    """One decode step: write K/V at ``pos`` (in place), attend over the
    cache ≤ pos.  Returns ``(y (B, 1, D), cache)``.

    ``ring=True`` (requires ``window`` and a cache of exactly ``window``
    slots) keeps only the last W tokens: slot i holds absolute position
    pos − ((pos − i) mod W)."""
    b, _, d = x.shape
    pos = int(pos)
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _project_qkv(p, x, None if cross else positions, rope_theta,
                                   compute_dtype)
    q = q.transpose(1, 2)                                   # (B, H, 1, Dh)

    if cross:
        k, v = cache["k"], cache["v"]
        allowed = torch.ones((k.shape[2],), dtype=torch.bool, device=dev)
    else:
        s_len = cache["k"].shape[2]
        if ring:
            assert window is not None and s_len == window
            slot = pos % window
        else:
            # dynamic_update_slice clamps the start into range
            slot = min(max(pos, 0), s_len - 1)
        cache["k"][:, :, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        k_idx = torch.arange(s_len, device=dev)
        if ring:
            allowed = (pos - torch.remainder(pos - k_idx, window)) >= 0
        else:
            allowed = k_idx <= pos
            if window is not None:
                in_window = (pos - k_idx) < window
                if prefix_len > 0:
                    in_window = in_window | (k_idx < prefix_len)
                allowed = allowed & in_window

    group = q.shape[1] // k.shape[1]
    kr = torch.repeat_interleave(k, group, dim=1) if group > 1 else k
    vr = torch.repeat_interleave(v, group, dim=1) if group > 1 else v
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), kr.float().transpose(-1, -2)) * scale
    s = torch.where(allowed[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.matmul(w, vr.float())
    out = out.to(compute_dtype).transpose(1, 2)             # (B, 1, H, Dh)
    return _out_proj(out, p["wo"], compute_dtype), cache
