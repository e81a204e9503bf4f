"""Dispatch for flash attention.

``impl``:
  "cuda"      — the hand-written kernel (kernel.py, csrc/flash_attention.cu);
                on CPU tensors the plain online-softmax version below.  The
                reference's "pallas".
  "reference" — the O(T²) oracle (ref.py);
  "chunked"   — the plain online softmax over KV blocks, the Pallas kernel's
                arithmetic in PyTorch ops.

Whenever autograd records (grad mode on and q, k or v requiring grad),
"cuda" and "chunked" run through ``chunked_vjp.FlashAttention``: the same
forward, which also keeps each row's logsumexp, and the reference's
FlashAttention backward (``chunked_vjp.py``), blockwise over KV blocks.  The
no-grad serving path calls the forward directly.  "reference" is
differentiated by autograd through its plain ops, as the reference's is.

On meta tensors (the dry-run) "cuda" returns the kernel's outputs as meta
tensors (``kernel.flash_attention_meta``) and launches nothing; the plain
versions run there as they are.

Layouts are the reference's, ``(B, H, T, D)``.  ``block_q`` is accepted for
the reference's signature and does not change the result (every query row is
independent); ``block_k`` sets the plain version's KV block.  The CUDA kernel
chooses its own tiles (64 × 64).  The reference pads T to the blocks and
masks keys past ``kv_len``; neither version here pads.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel as _kernel
from .ref import NEG_INF, attention_ref, visible

IMPLS = ("cuda", "reference", "chunked")
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def block_visible(q_lo: int, q_hi: int, k_lo: int, k_hi: int, causal: bool,
                  window: Optional[int], prefix_len: int) -> bool:
    """Whether any key in ``[k_lo, k_hi]`` is visible to any absolute query
    position in ``[q_lo, q_hi]``.  The differences ``q - k`` fill
    ``[q_lo - k_hi, q_hi - k_lo]``, so the causal and window terms hide the
    block exactly when that range misses ``[0, window)``.  A hidden block
    adds nothing to the online softmax, so skipping it changes no result."""
    if prefix_len > 0 and k_lo < prefix_len:
        return True
    if causal and q_hi < k_lo:
        return False
    if window is not None and q_lo - k_hi >= window:
        return False
    return True


def chunked_attention(
    q: torch.Tensor,              # (B, Hq, Tq, D)
    k: torch.Tensor,              # (B, Hkv, Tk, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    kv_offset: int = 0,
    scale: Optional[float] = None,
    block_k: int = DEFAULT_BLOCK_K,
    return_lse: bool = False,
):
    """Online softmax over KV blocks in f32, as the Pallas kernel computes it
    (``kernel.py:59-100``): NEG_INF sentinel, ``p`` zeroed where hidden, the
    final ``max(l, 1e-30)``.  Query heads are grouped over their KV head, so
    K/V are never repeated.  With ``return_lse``, ``(out, lse)``: each row's
    ``m + log(max(l, 1e-30))`` ``(B, Hq, Tq)`` f32, as the reference's
    ``chunked_vjp.py:118`` forms it (-1e30 for a row whose keys are all
    hidden)."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    dev = q.device
    # (B, Hkv, group·Tq, D): row r of a KV head is query head h·group + r // Tq.
    qg = q.float().reshape(b, hkv, group * tq, d)
    q_pos = torch.arange(tq, device=dev).repeat(group) + kv_offset
    m = torch.full((b, hkv, group * tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group * tq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, tk, block_k):
        k1 = min(k0 + block_k, tk)
        if tq == 0 or not block_visible(kv_offset, tq - 1 + kv_offset, k0, k1 - 1,
                                        causal, window, prefix_len):
            continue
        kb = k[:, :, k0:k1].float()
        vb = v[:, :, k0:k1].float()
        s = torch.matmul(qg, kb.transpose(-1, -2)) * scale
        mask = visible(q_pos[:, None], torch.arange(k0, k1, device=dev)[None, :],
                       causal, window, prefix_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    out = (acc / denom[..., None]).reshape(b, hq, tq, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom)).reshape(b, hq, tq)
    return out


def flash_attention(
    q: torch.Tensor,              # (B, Hq, Tq, D)
    k: torch.Tensor,              # (B, Hkv, Tk, D)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    kv_offset: int = 0,
    scale: Optional[float] = None,
    impl: str = "cuda",
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Attention output ``(B, Hq, Tq, D)`` in ``q.dtype``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown flash_attention impl {impl!r}; expected {IMPLS}")
    if impl != "reference" and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        from .chunked_vjp import FlashAttention

        return FlashAttention.apply(q, k, v, causal, window, prefix_len, kv_offset, scale,
                                    impl, block_k)
    if impl == "reference":
        return attention_ref(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
                             kv_offset=kv_offset, scale=scale)
    if impl == "cuda" and q.device.type == "meta":
        return _kernel.flash_attention_meta(q, k, v, causal=causal, window=window,
                                            prefix_len=prefix_len, kv_offset=kv_offset,
                                            scale=scale)
    if impl == "cuda" and q.device.type != "cpu":
        return _kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                            prefix_len=prefix_len, kv_offset=kv_offset,
                                            scale=scale)
    return chunked_attention(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
                             kv_offset=kv_offset, scale=scale, block_k=block_k)
