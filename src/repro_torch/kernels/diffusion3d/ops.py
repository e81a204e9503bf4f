"""Dispatch for the diffusion stencil.

  impl="cuda"       the hand-written kernel (kernel.py, csrc/diffusion3d.cu);
                    on CPU tensors the plain version.
  impl="reference"  the plain PyTorch version (ref.py).
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import diffusion_step_ref

IMPLS = ("cuda", "reference")


def diffusion_step(u: torch.Tensor, nu_dt_dx2: float, decay_dt: float = 0.0,
                   impl: str = "cuda") -> torch.Tensor:
    """One Eq-4.3 step, zero outside the grid, of ``u`` (nx, ny, nz) or of
    each field of ``u`` (B, nx, ny, nz) (one launch for all B)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown diffusion_step impl {impl!r}; expected {IMPLS}")
    if impl == "cuda" and u.device.type != "cpu":
        return _kernel.diffusion_step_cuda(u.contiguous(), nu_dt_dx2, decay_dt)
    return diffusion_step_ref(u, nu_dt_dx2, decay_dt)
