"""ctypes wrapper of ``csrc/rmsnorm.cu`` (replaces the Pallas
``rmsnorm_rows``; the design note is in the source).

``launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# dtype codes shared with the launcher in csrc/rmsnorm.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("rmsnorm")
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_launch.argtypes = [_I, _P, _I, _P, _I, _P, _I, _I, _F, _P]
        lib.rmsnorm_launch.restype = _I
        lib._typed = True
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.ndim != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} / scale {tuple(scale.shape)} "
                         f"must be (N, D) / (D,)")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in DTYPES:
            raise ValueError(f"rmsnorm: {name} must be float32 or bfloat16, got {t.dtype}")


def rmsnorm_meta(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's output on meta tensors (the dry-run), after its checks:
    launches and counts nothing."""
    _check(x, scale)
    return torch.empty_like(x)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x (N, D)`` f32 / bf16, ``scale (D,)`` f32 / bf16 →
    ``(N, D)`` in ``x.dtype``."""
    global launches
    _check(x, scale)
    _build.require_cuda("rmsnorm", x, scale)
    n, d = x.shape
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    lib = _lib()
    _build.check(
        lib.rmsnorm_launch(x.device.index, _build.ptr(x), DTYPES[x.dtype],
                           _build.ptr(scale), DTYPES[scale.dtype], _build.ptr(out),
                           n, d, float(eps), _build.stream_of(x)),
        "rmsnorm",
    )
    launches += 1
    return out
