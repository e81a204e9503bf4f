"""ctypes wrapper of ``csrc/diffusion3d.cu`` (replaces the Pallas
``diffusion_step_pallas``; the design note is in the source).

``launches`` counts the wrapper's kernel launches: one a call, for one
field or a batch's B fields.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("diffusion3d")
    if not getattr(lib, "_typed", False):
        lib.diffusion3d_launch.argtypes = [_I, _P, _P, _I, _I, _I, _I, _F, _F, _P]
        lib.diffusion3d_launch.restype = _I
        lib._typed = True
    return lib


def diffusion_step_cuda(u: torch.Tensor, nu_dt_dx2: float, decay_dt: float
                        ) -> torch.Tensor:
    """One Eq-4.3 step of ``u (nx, ny, nz) f32`` into a new tensor; of each
    of B fields of ``u (B, nx, ny, nz)`` in one launch (no halo crosses from
    one field to the next)."""
    global launches
    if u.dtype != torch.float32 or u.ndim not in (3, 4):
        raise ValueError(f"diffusion_step: u must be (nx, ny, nz) or (B, nx, ny, nz) "
                         f"float32, got {u.dtype} {tuple(u.shape)}")
    _build.require_cuda("diffusion_step", u)
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    slots = u.shape[0] if u.ndim == 4 else 1
    nx, ny, nz = u.shape[-3:]
    # The coefficients round to f32 exactly as the reference's python floats
    # do when they meet an f32 array: 1 − decay_dt is formed in double first.
    nu = float(np.float32(nu_dt_dx2))
    keep = float(np.float32(1.0 - decay_dt))
    _build.check(
        _lib().diffusion3d_launch(u.device.index, _build.ptr(u), _build.ptr(out),
                                  slots, nx, ny, nz, nu, keep, _build.stream_of(u)),
        "diffusion3d",
    )
    launches += 1
    return out
