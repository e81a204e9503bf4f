"""ctypes wrappers of the flash-attention kernels (all replace the Pallas
``flash_attention_flat``; the design notes are in the sources).

Which kernel runs is a fixed rule on dtype and head dim, not a fallback:

  bf16, D 64 or 128     ``csrc/flash_attention_wgmma.cu``: wgmma products fed
                        by TMA, two warpgroups of 64 query rows;
  bf16, D 256           ``csrc/flash_attention_wgmma_d256.cu``: wgmma fed by
                        TMA, the head dim split over two warpgroups, warp
                        specialised (``launches_tc`` counts the launches of
                        both tensor-core kernels);
  f32, or D 16          ``csrc/flash_attention.cu``: f32 FMAs on the SIMT
                        cores (``launches``); it also takes bf16 at D 256
                        when called as ``flash_attention_simt_cuda``.

All take the reference's ``(B, H, T, D)`` layout as strided views: the
feature axis must be contiguous, the other three axes may have any strides,
so the ``(B, T, H, D)`` projections of the model go in without a copy (the
tensor-core kernels' TMA copies also need 16-byte aligned pointers and
strides that are multiples of 8 values).  The output is allocated with
``q``'s strides.  With ``return_lse=True`` a kernel also writes each query
row's logsumexp, ``m + log(max(l, 1e-30))`` in natural-log units, ``(B, Hq,
Tq)`` f32 (-1e30 for a row whose keys are all hidden): the Pallas kernel's
``m`` and ``l`` outputs as the reference's backward forms them
(``chunked_vjp.py:118``).  Serving passes no buffer and writes nothing
more.  A launch that fails raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .ref import NEG_INF

launches = 0          # csrc/flash_attention.cu (SIMT)
launches_tc = 0       # csrc/flash_attention_wgmma{,_d256}.cu (tensor cores)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# dtype codes shared with the launcher in csrc/flash_attention.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)
# head dim -> (library, launcher) of the tensor-core kernel that takes it
TC_KERNELS = {64: ("flash_attention_wgmma", "flash_attention_wgmma_launch"),
              128: ("flash_attention_wgmma", "flash_attention_wgmma_launch"),
              256: ("flash_attention_wgmma_d256", "flash_attention_wgmma_d256_launch")}


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """The dispatch rule: bf16 at D 64, 128 or 256 runs a wgmma kernel."""
    return dtype == torch.bfloat16 and head_dim in TC_KERNELS


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = [
            _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F, _P,
        ]
        lib.flash_attention_launch.restype = _I
        lib._typed = True
    return lib


def _launcher_tc(d: int):
    """The launcher of the tensor-core kernel for head dim ``d`` (both take
    the same arguments)."""
    name, fn_name = TC_KERNELS[d]
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if not getattr(lib, "_typed", False):
        fn.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F, _P,
        ]
        fn.restype = _I
        lib._typed = True
    return fn


def _lse_ptr(lse: Optional[torch.Tensor]):
    return None if lse is None else _build.ptr(lse)


def _tma_strides(name: str, t: torch.Tensor) -> list:
    """(batch, head, time) element strides of ``t`` for a TMA tensor map:
    16-byte multiples (8 bf16 values); an axis of length 1 is never stepped,
    so its stride is replaced by one that is."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary")
    out = []
    for i in range(3):
        s = t.stride(i) if t.shape[i] > 1 else t.shape[3]
        if s % 8:
            raise ValueError(f"flash_attention: the stride of axis {i} of {name} ({s}) "
                             f"must be a multiple of 8 values for the tensor-core kernel")
        out.append(s)
    return out


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Shapes ``(b, hq, hkv, tq, tk, d)`` after the shape, dtype and layout
    checks all kernels share."""
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
    return b, hq, hkv, tq, tk, d


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Shapes ``(b, hq, hkv, tq, tk, d)`` after ``_shapes``' checks and the
    device checks all kernels share."""
    b, hq, hkv, tq, tk, d = _shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: expects CUDA tensors, {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and {t.device}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {b * hq} exceeds the grid's y limit")
    return b, hq, hkv, tq, tk, d


def _outputs(q, b, hq, tq, return_lse):
    """The output (``q``'s strides when q is dense, else contiguous) and,
    when asked for, the ``(B, Hq, Tq)`` f32 lse buffer."""
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    return out, lse


def _empty_result(out, lse, tk):
    """The result without a launch: no query rows, or no keys (output 0 and
    lse -1e30 + log(1e-30), as the reference forms it for a hidden row)."""
    if tk == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(NEG_INF + math.log(1e-30))
    return (out, lse) if lse is not None else out


def flash_attention_simt_cuda(q, k, v, *, causal=True, window=None, prefix_len=0,
                              kv_offset=0, scale=None, return_lse=False):
    """``csrc/flash_attention.cu`` on any supported dtype and head dim;
    ``(out, lse)`` with ``return_lse``."""
    global launches
    b, hq, hkv, tq, tk, d = _checked(q, k, v)
    out, lse = _outputs(q, b, hq, tq, return_lse)
    if q.numel() == 0 or tk == 0:
        return _empty_result(out, lse, tk)
    scale_v = (d ** -0.5) if scale is None else scale
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    _build.check(
        _lib().flash_attention_launch(
            q.device.index, DTYPES[q.dtype], d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(out), _lse_ptr(lse), b, hq, hkv, tq, tk, ctypes.cast(strides, _P),
            int(causal), int(window is not None), int(window or 0), int(prefix_len),
            int(kv_offset), float(scale_v), _build.stream_of(q)),
        "flash_attention",
    )
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_wgmma_cuda(q, k, v, *, causal=True, window=None, prefix_len=0,
                               kv_offset=0, scale=None, return_lse=False):
    """``csrc/flash_attention_wgmma.cu`` (bf16 at head dim 64 or 128) or
    ``csrc/flash_attention_wgmma_d256.cu`` (bf16 at 256); ``(out, lse)``
    with ``return_lse``."""
    global launches_tc
    b, hq, hkv, tq, tk, d = _checked(q, k, v)
    if not uses_tensor_cores(q.dtype, d):
        raise ValueError(f"flash_attention: the tensor-core kernel takes bf16 at head_dim "
                         f"{tuple(TC_KERNELS)}, got {q.dtype} at {d}")
    out, lse = _outputs(q, b, hq, tq, return_lse)
    if q.numel() == 0 or tk == 0:
        return _empty_result(out, lse, tk)
    scale_v = (d ** -0.5) if scale is None else scale
    st = [s for name, t in (("q", q), ("k", k), ("v", v)) for s in _tma_strides(name, t)]
    strides = (ctypes.c_longlong * 12)(*st, *[out.stride(i) for i in range(3)])
    _build.check(
        _launcher_tc(d)(
            q.device.index, d, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _lse_ptr(lse), b, hq, hkv, tq, tk, ctypes.cast(strides, _P), int(causal),
            int(window is not None), int(window or 0), int(prefix_len), int(kv_offset),
            float(scale_v), _build.stream_of(q)),
        "flash_attention (tensor cores)",
    )
    launches_tc += 1
    return (out, lse) if return_lse else out


# Told of every call that ``flash_attention_meta`` stands in for a launch, as
# ``fn(q_shape, k_shape, causal, window, prefix_len, kv_offset)``: the
# dry-run (``launch/dryrun.py``) adds the kernel's FLOPs there.
meta_observers: list = []


def flash_attention_meta(q, k, v, *, causal=True, window=None, prefix_len=0, kv_offset=0,
                         scale=None, return_lse=False):
    """The kernel's outputs on meta tensors (the dry-run): ``out`` (and
    ``lse``) as ``flash_attention_cuda`` allocates them, after its shape,
    dtype and layout checks.  It launches and computes nothing and counts
    no launch."""
    b, hq, hkv, tq, tk, d = _shapes(q, k, v)
    out, lse = _outputs(q, b, hq, tq, return_lse)
    for fn in meta_observers:
        fn(tuple(q.shape), tuple(k.shape), causal, window, prefix_len, kv_offset)
    return (out, lse) if return_lse else out


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
    return_lse: bool = False,
):
    """Attention output ``(B, Hq, Tq, D)`` in ``q.dtype`` (f32 or bf16), f32
    arithmetic inside, and with ``return_lse`` the rows' logsumexp ``(B, Hq,
    Tq)`` f32; the kernel is chosen by ``uses_tensor_cores``."""
    tc = q.ndim == 4 and uses_tensor_cores(q.dtype, q.shape[3])
    kernel = flash_attention_wgmma_cuda if tc else flash_attention_simt_cuda
    return kernel(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
                  kv_offset=kv_offset, scale=scale, return_lse=return_lse)
