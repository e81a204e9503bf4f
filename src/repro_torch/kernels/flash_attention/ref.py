"""Plain PyTorch oracle for flash attention: masked softmax attention with
GQA, causal, sliding-window and prefix-LM masks.  O(T²) memory.

Port of ``repro/kernels/flash_attention/ref.py``.
"""

from __future__ import annotations

import math
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


def wgmma_arithmetic_ref(
    q: torch.Tensor,              # (B, Hq, Tq, D) bf16
    k: torch.Tensor,              # (B, Hkv, Tk, D) bf16
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    kv_offset: int = 0,
    scale: Optional[float] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """The tensor-core kernels' arithmetic (``csrc/flash_attention_wgmma.cu``
    at D 64 / 128, ``csrc/flash_attention_wgmma_d256.cu`` at D 256: the
    latter splits only the columns of O and P V over its warpgroups, each of
    which sums the whole of S in the same order) in plain PyTorch, for the
    tests only: S = Q Kᵀ of the bf16 values in f32,
    the online softmax over ``block_k``-key tiles as the Pallas kernel does it
    (NEG_INF sentinel, p zeroed where hidden, final ``max(l, 1e-30)``) but
    with the running max m in raw-score units and p = 2^((s − m) · scale ·
    log2 e), and P split into three bf16 terms hi = bf16(p), mid = bf16(p −
    hi), lo = bf16(p − hi − mid), each multiplied by V in f32, summed per tile
    and added to the rescaled accumulator.  The output is rounded once to
    bf16."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                          dtype=torch.float32)
    dev = q.device
    bf = torch.bfloat16
    sl2 = scale_log2.to(dev)
    qg = q.to(bf).float().reshape(b, hkv, group * tq, d)
    q_pos = torch.arange(tq, device=dev).repeat(group) + kv_offset
    m = torch.full((b, hkv, group * tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group * tq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, tk, block_k):
        k1 = min(k0 + block_k, tk)
        kb = k[:, :, k0:k1].to(bf).float()
        vb = v[:, :, k0:k1].to(bf).float()
        s = torch.matmul(qg, kb.transpose(-1, -2))
        mask = visible(q_pos[:, None], torch.arange(k0, k1, device=dev)[None, :],
                       causal, window, prefix_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * sl2)
        p = torch.where(mask, torch.exp2((s - m_new[..., None]) * sl2), 0.0)
        l = alpha * l + p.sum(dim=-1)
        hi = p.to(bf).float()
        mid = (p - hi).to(bf).float()
        lo = (p - hi - mid).to(bf).float()
        pv = torch.matmul(lo, vb) + torch.matmul(mid, vb) + torch.matmul(hi, vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, tq, d).to(bf)
