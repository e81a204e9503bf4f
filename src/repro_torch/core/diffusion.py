"""Extracellular diffusion (§4.5.2, Eq 4.3).

Port of ``repro.core.diffusion``: Fick's second law with decay on a regular
grid, central differences, zero concentration outside the space.  Agents
couple to the grid through ``increase_concentration`` (secretion) and
``gradient_at`` / ``concentration_at`` (chemotaxis).  ``diffuse`` runs the
``kernels/diffusion3d`` CUDA kernel with ``impl="cuda"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .grid import device_constant, fdiv
from .slots import row_slot

IMPLS = ("reference", "cuda")


@dataclasses.dataclass(frozen=True)
class DiffusionGrid:
    """One extracellular substance on a regular grid over the sim space.

    ``n_valid`` / ``frame_shift`` are the reference's ghost-voxel padding
    fields of uneven distributed splits; ``None`` single-node.  The fields
    marked ``static`` are the reference's static pytree metadata: a
    checkpoint holds no array for them.  In a batch's flat view
    (``core/slots.py``) ``concentration`` is (B, nx, ny, nz), one field a
    session, and agent positions are B blocks of rows, block b in field b.
    """

    concentration: torch.Tensor  # (nx, ny, nz) float32
    origin: Tuple[float, float, float] = dataclasses.field(metadata=dict(static=True))
    spacing: float = dataclasses.field(metadata=dict(static=True))
    diffusion_coefficient: float = dataclasses.field(metadata=dict(static=True))
    decay_constant: float = dataclasses.field(metadata=dict(static=True))
    n_valid: torch.Tensor | None = None       # (3,) i32 valid voxels per dim
    frame_shift: torch.Tensor | None = None   # (3,) f32 lattice offset of voxel 0

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.concentration.shape[-3:])  # type: ignore[return-value]

    @property
    def slots(self) -> int | None:
        """B for a batch's fields, None solo."""
        return self.concentration.shape[0] if self.concentration.ndim == 4 else None


def make_grid(
    min_bound: float,
    max_bound: float,
    resolution: int,
    diffusion_coefficient: float,
    decay_constant: float = 0.0,
    device: torch.device | str = "cpu",
) -> DiffusionGrid:
    spacing = (max_bound - min_bound) / resolution
    conc = torch.zeros((resolution,) * 3, dtype=torch.float32, device=device)
    return DiffusionGrid(
        concentration=conc,
        origin=(min_bound, min_bound, min_bound),
        spacing=spacing,
        diffusion_coefficient=diffusion_coefficient,
        decay_constant=decay_constant,
    )


def stability_limit(grid: DiffusionGrid) -> float:
    """Max Δt for explicit-scheme stability: Δt ≤ Δx²/(6ν)."""
    return grid.spacing**2 / (6.0 * max(grid.diffusion_coefficient, 1e-30))


def _laplacian_zero_outside(u: torch.Tensor, dx: float) -> torch.Tensor:
    """7-point Laplacian with zero concentration outside the boundary."""
    z = F.pad(u, (1, 1, 1, 1, 1, 1))
    lap = (
        z[..., 2:, 1:-1, 1:-1]
        + z[..., :-2, 1:-1, 1:-1]
        + z[..., 1:-1, 2:, 1:-1]
        + z[..., 1:-1, :-2, 1:-1]
        + z[..., 1:-1, 1:-1, 2:]
        + z[..., 1:-1, 1:-1, :-2]
        - 6.0 * u
    )
    return fdiv(lap, dx * dx)


def diffuse(grid: DiffusionGrid, dt: float, impl: str = "reference") -> DiffusionGrid:
    """One explicit central-difference step of Eq 4.3.

    ``impl="cuda"`` runs ``kernels.diffusion3d`` (its plain version on CPU
    tensors); ``"reference"`` is the reference's own formula (Laplacian
    divided by Δx², then scaled by νΔt).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown diffusion impl {impl!r}; expected {IMPLS}")
    if impl == "cuda":
        from repro_torch.kernels.diffusion3d import ops as d3_ops

        new = d3_ops.diffusion_step(
            grid.concentration,
            nu_dt_dx2=grid.diffusion_coefficient * dt / grid.spacing**2,
            decay_dt=grid.decay_constant * dt,
            impl="cuda",
        )
        return dataclasses.replace(grid, concentration=new)
    u = grid.concentration
    lap = _laplacian_zero_outside(u, grid.spacing)
    new = u * (1.0 - grid.decay_constant * dt) + grid.diffusion_coefficient * dt * lap
    return dataclasses.replace(grid, concentration=new)


# ---------------------------------------------------------------- coupling

def _grid_coords(grid: DiffusionGrid, position: torch.Tensor) -> torch.Tensor:
    origin = device_constant(("origin", grid.origin), position.device,
                             lambda: torch.tensor(grid.origin, dtype=torch.float32))
    rel = position - origin
    if grid.frame_shift is not None:
        rel = rel - grid.frame_shift
    return fdiv(rel, grid.spacing) - 0.5  # fractional voxel coords (cell-centered)


def _effective_resolution(grid: DiffusionGrid, device: torch.device) -> torch.Tensor:
    """(3,) i32 — the valid voxel count when padded, else the resolution."""
    if grid.n_valid is not None:
        return grid.n_valid.to(device=device, dtype=torch.int32)
    return device_constant(("dims", grid.resolution), device,
                           lambda: torch.tensor(grid.resolution, dtype=torch.int32))


def _nearest_voxel(grid: DiffusionGrid, position: torch.Tensor) -> torch.Tensor:
    res = _effective_resolution(grid, position.device)
    # torch.round, like jnp.round, rounds half to even.
    ijk = torch.round(_grid_coords(grid, position)).to(torch.int32)
    return torch.minimum(torch.clamp(ijk, min=0), res - 1)


def _flat(grid: DiffusionGrid, ijk: torch.Tensor) -> torch.Tensor:
    """Flat voxel index of ``ijk`` (N, 3); in a batch's fields the rows are
    the flat view's, each offset into its own session's field."""
    nx, ny, nz = grid.resolution
    flat = ((ijk[..., 0].long() * ny + ijk[..., 1]) * nz + ijk[..., 2]).reshape(-1)
    if grid.slots is not None:
        flat = flat + row_slot(flat.shape[0], grid.slots, flat.device) * (nx * ny * nz)
    return flat


def increase_concentration(
    grid: DiffusionGrid, position: torch.Tensor, amount, mask: torch.Tensor | None = None
) -> DiffusionGrid:
    """Scatter-add secretion at agent positions (Algorithm 6).  Repeated
    voxels accumulate in agent-index order on the CPU; on the card the
    deterministic ``index_put_`` sums them in a fixed order too (a stable
    sort of the indices, then each run of equal ones in order), so a batch's
    one scatter over all sessions sums each voxel as the session's solo
    scatter does."""
    ijk = _nearest_voxel(grid, position)
    if isinstance(amount, (int, float)):   # a fill, not a host-to-device copy
        amount = torch.full((), amount, dtype=torch.float32, device=position.device)
    else:
        amount = torch.as_tensor(amount, dtype=torch.float32, device=position.device)
    amount = amount.expand(position.shape[:-1])
    if mask is not None:
        amount = torch.where(mask, amount, 0.0)
    flat = grid.concentration.reshape(-1).clone()
    flat.index_put_((_flat(grid, ijk),), amount.reshape(-1), accumulate=True)
    return dataclasses.replace(grid, concentration=flat.reshape(grid.concentration.shape))


def concentration_at(grid: DiffusionGrid, position: torch.Tensor) -> torch.Tensor:
    ijk = _nearest_voxel(grid, position)
    flat = grid.concentration.reshape(-1)[_flat(grid, ijk)]
    return flat.reshape(position.shape[:-1])


def gradient_at(grid: DiffusionGrid, position: torch.Tensor, normalized: bool = True
                ) -> torch.Tensor:
    """Central-difference gradient sampled at agent positions (Algorithm 7)."""
    res = _effective_resolution(grid, position.device)
    ijk = _nearest_voxel(grid, position)
    conc = grid.concentration.reshape(-1)

    def sample(off: Tuple[int, int, int]) -> torch.Tensor:
        o = device_constant(("offset", off), position.device,
                            lambda: torch.tensor(off, dtype=torch.int32))
        q = torch.minimum(torch.clamp(ijk + o, min=0), res - 1)
        return conc[_flat(grid, q)].reshape(position.shape[:-1])

    two_dx = 2.0 * grid.spacing
    gx = fdiv(sample((1, 0, 0)) - sample((-1, 0, 0)), two_dx)
    gy = fdiv(sample((0, 1, 0)) - sample((0, -1, 0)), two_dx)
    gz = fdiv(sample((0, 0, 1)) - sample((0, 0, -1)), two_dx)
    g = torch.stack([gx, gy, gz], dim=-1)
    if normalized:
        norm = torch.sqrt((g * g).sum(dim=-1, keepdim=True))
        g = torch.where(norm > 1e-12, g / torch.clamp(norm, min=1e-12), 0.0)
    return g


def analytical_point_source(q: float, d: float, r: torch.Tensor, t) -> torch.Tensor:
    """Instantaneous point source in free 3D space (Fig 4.9 convergence test):

        u(r, t) = Q / (4πDt)^{3/2} · exp(−r² / (4Dt))
    """
    denom = (4.0 * math.pi * d * t) ** 1.5
    return q / denom * torch.exp(-(r * r) / (4.0 * d * t))
