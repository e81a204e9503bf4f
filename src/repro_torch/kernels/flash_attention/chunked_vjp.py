"""The FlashAttention backward, as a ``torch.autograd.Function`` over the
forward kernels.

Port of ``repro/kernels/flash_attention/chunked_vjp.py``.  The forward is the
port's forward: on the card the CUDA kernel (``kernel.flash_attention_cuda``,
a tensor-core kernel for bf16 at D 64 / 128 / 256, else the SIMT one), on CPU
tensors the plain ``ops.chunked_attention``; either writes each query row's
logsumexp.  It saves ``(q, k, v, out, lse)`` and nothing else.  The backward
re-forms each KV block's probabilities from the saved logsumexp and
accumulates dq / dk / dv blockwise (``chunked_vjp.py:130-163``):

    p   = exp(q·kᵀ·s − lse)            (recomputed per block, masked)
    dv += pᵀ · do
    dp  = do · vᵀ
    ds  = p ⊙ (dp − rowsum(do ⊙ out)) · s
    dq += ds · k ;   dk += dsᵀ · q

in f32, as the reference's upcast blocks are.  GQA is folded as in the
reference's ``ops.py:77-81``: a KV head's query heads are rows of one
``(group · Tq, D)`` block, so dk and dv sum over them and K/V are never
repeated.  The visibility is the forward's (causal, window, prefix,
``kv_offset``); a row whose keys are all hidden has lse -1e30 and p 0.  A
block skips the query rows that see none of its keys, which changes no sum
(their p is 0).

The reference's backward is plain ``jnp``, not a Pallas kernel, so this
plain PyTorch backward is a full port of it; a hand-written backward kernel
is later performance work (ROADMAP §0).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel as _kernel
from .ref import NEG_INF, visible


def _row_range(tq: int, k0: int, k1: int, causal: bool, window: Optional[int],
               prefix_len: int, kv_offset: int):
    """``[r0, r1)``: the query rows (absolute position ``r + kv_offset``) that
    may see a key in ``[k0, k1)``; every other row sees none of them."""
    if prefix_len > 0 and k0 < prefix_len:
        return 0, tq
    r0 = max(0, k0 - kv_offset) if causal else 0
    r1 = tq if window is None else min(tq, k1 - 1 + window - kv_offset)
    return r0, max(r0, r1)


def attention_backward(q, k, v, out, lse, dout, causal=True, window=None, prefix_len=0,
                       kv_offset=0, scale=None, block_k=1024):
    """``(dq, dk, dv)`` in the dtypes of q, k, v from the forward's
    ``out`` and ``lse`` and the output's gradient ``dout``."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    dev = q.device
    rows = (b, hkv, group, tq)
    q5 = q.float().reshape(*rows, d)
    do5 = dout.float().reshape(*rows, d)
    lse4 = lse.reshape(rows)
    delta4 = (do5 * out.float().reshape(*rows, d)).sum(dim=-1)
    dq5 = torch.zeros((*rows, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, hkv, tk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for k0 in range(0, tk, block_k):
        k1 = min(k0 + block_k, tk)
        r0, r1 = _row_range(tq, k0, k1, causal, window, prefix_len, kv_offset)
        if r0 == r1:
            continue
        n = r1 - r0
        fold = lambda t: t[:, :, :, r0:r1].reshape(b, hkv, group * n, *t.shape[4:])
        qb, dob, lse_b, delta_b = fold(q5), fold(do5), fold(lse4), fold(delta4)
        kb = k[:, :, k0:k1].float()
        vb = v[:, :, k0:k1].float()
        q_pos = torch.arange(r0, r1, device=dev).repeat(group) + kv_offset
        mask = visible(q_pos[:, None], torch.arange(k0, k1, device=dev)[None, :],
                       causal, window, prefix_len)
        s = torch.where(mask, torch.matmul(qb, kb.transpose(-1, -2)) * scale, NEG_INF)
        p = torch.where(mask, torch.exp(s - lse_b[..., None]), 0.0)
        del s
        dv[:, :, k0:k1] = torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, vb.transpose(-1, -2))
        ds = p * (dp - delta_b[..., None]) * scale
        del p, dp
        dq5[:, :, :, r0:r1] += torch.matmul(ds, kb).reshape(b, hkv, group, n, d)
        dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qb)
    return dq5.reshape(b, hq, tq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window, prefix_len, kv_offset,
    scale, impl, block_k)``: the output ``(B, Hq, Tq, D)`` in ``q.dtype``,
    differentiable in q, k and v.  ``impl="cuda"`` launches the kernel for
    CUDA tensors (on meta tensors it stands in for the kernel with empty
    outputs, and the backward runs on meta); ``"chunked"``, or CPU tensors,
    run the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, kv_offset, scale, impl, block_k):
        kw = dict(causal=causal, window=window, prefix_len=prefix_len, kv_offset=kv_offset,
                  scale=scale, return_lse=True)
        if impl == "cuda" and q.device.type == "meta":
            out, lse = _kernel.flash_attention_meta(q, k, v, **kw)
        elif impl == "cuda" and q.device.type != "cpu":
            out, lse = _kernel.flash_attention_cuda(q, k, v, **kw)
        else:
            from .ops import chunked_attention

            out, lse = chunked_attention(q, k, v, block_k=block_k, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, prefix_len, kv_offset, scale, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, dout, *ctx.masks)
        return dq, dk, dv, None, None, None, None, None, None, None
