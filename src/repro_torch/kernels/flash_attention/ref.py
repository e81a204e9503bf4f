"""Plain PyTorch oracle for flash attention: masked softmax attention with
GQA, causal, sliding-window and prefix-LM masks.  O(T²) memory.

Port of ``repro/kernels/flash_attention/ref.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def visible(q_idx: torch.Tensor, k_idx: torch.Tensor, causal: bool, window: Optional[int],
            prefix_len: int) -> torch.Tensor:
    """The mask terms of the reference, in its order: causal ``q >= k``, then
    the window ``(q - k) < window``, then OR the prefix ``k < prefix_len``.
    ``q_idx`` are absolute query positions (``kv_offset`` added)."""
    vis = torch.ones(torch.broadcast_shapes(q_idx.shape, k_idx.shape), dtype=torch.bool,
                     device=q_idx.device)
    if causal:
        vis = q_idx >= k_idx
    if window is not None:
        vis = vis & ((q_idx - k_idx) < window)
    if prefix_len > 0:
        vis = vis | (k_idx < prefix_len)
    return vis


def attention_ref(
    q: torch.Tensor,              # (B, Hq, Tq, D)
    k: torch.Tensor,              # (B, Hkv, Tk, D)
    v: torch.Tensor,              # (B, Hkv, Tk, D)
    causal: bool = True,
    window: Optional[int] = None,   # sliding window size (None = full)
    kv_offset: int = 0,             # absolute position of q[0] minus that of k[0]
    prefix_len: int = 0,            # prefix-LM: keys < prefix always visible
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    assert hq % hkv == 0
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    kr = torch.repeat_interleave(k, group, dim=1)          # (B, Hq, Tk, D)
    vr = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    q_idx = torch.arange(tq, device=q.device)[:, None] + kv_offset
    k_idx = torch.arange(tk, device=q.device)[None, :]
    mask = visible(q_idx, k_idx, causal, window, prefix_len)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)
