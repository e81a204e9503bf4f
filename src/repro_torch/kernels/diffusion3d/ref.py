"""Plain PyTorch version of the 3-D diffusion stencil (Eq 4.3).

Sums the six neighbours in the Pallas kernel's order (``xm + xp + ym + yp
+ zm + zp − 6u``; ``repro/kernels/diffusion3d/ref.py`` adds them as
``xp + xm + …``), so that on the card the kernel and this version agree
bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def diffusion_step_ref(u: torch.Tensor, nu_dt_dx2: float, decay_dt: float
                       ) -> torch.Tensor:
    """One explicit central-difference step with zero-outside boundary:

        u⁺ = u·(1 − μΔt) + νΔt/Δx²·(Σ_neighbors u − 6u)

    ``u`` is (nx, ny, nz), or (B, nx, ny, nz): B fields stepped each on its
    own (the slot axis of a batch)."""
    z = F.pad(u, (1, 1, 1, 1, 1, 1))
    lap = (
        z[..., :-2, 1:-1, 1:-1]
        + z[..., 2:, 1:-1, 1:-1]
        + z[..., 1:-1, :-2, 1:-1]
        + z[..., 1:-1, 2:, 1:-1]
        + z[..., 1:-1, 1:-1, :-2]
        + z[..., 1:-1, 1:-1, 2:]
        - 6.0 * u
    )
    return u * (1.0 - decay_dt) + nu_dt_dx2 * lap
