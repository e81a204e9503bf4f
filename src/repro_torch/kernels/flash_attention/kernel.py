"""ctypes wrapper of ``csrc/flash_attention.cu`` (replaces the Pallas
``flash_attention_flat``; the design note is in the source).

Takes the reference's ``(B, H, T, D)`` layout as strided views: the feature
axis must be contiguous, the other three axes may have any strides, so the
``(B, T, H, D)`` projections of the model go in without a copy.  The output
is allocated with ``q``'s strides.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# dtype codes shared with the launcher in csrc/flash_attention.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = [
            _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F, _P,
        ]
        lib.flash_attention_launch.restype = _I
        lib._typed = True
    return lib


def flash_attention_cuda(
    q: torch.Tensor,              # (B, Hq, Tq, D)
    k: torch.Tensor,              # (B, Hkv, Tk, D)
    v: torch.Tensor,              # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    kv_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention output ``(B, Hq, Tq, D)`` in ``q.dtype`` (f32 or bf16), f32
    arithmetic inside."""
    global launches
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B, Hq, Tq, D) and (B, Hkv, Tk, D)")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share B and D, and Hkv must divide Hq")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: the feature axis of {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: expects CUDA tensors, {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and {t.device}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {b * hq} exceeds the grid's y limit")
    out = torch.empty_like(q)       # q's strides when q is dense, else contiguous
    if q.numel() == 0:
        return out
    if tk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    scale_v = (d ** -0.5) if scale is None else scale
    lib = _lib()
    _build.check(
        lib.flash_attention_launch(
            q.device.index, DTYPES[q.dtype], d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(out), b, hq, hkv, tq, tk, ctypes.cast(strides, _P), int(causal),
            int(window is not None), int(window or 0), int(prefix_len), int(kv_offset),
            float(scale_v), _build.stream_of(q)),
        "flash_attention",
    )
    launches += 1
    return out
