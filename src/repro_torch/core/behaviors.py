"""Agent behaviors (§4.2.1, Appendix D).

Port of ``repro.core.behaviors``.  A behavior is a function
``(ctx, pool) -> (ctx, pool)`` over all agents at once; it reads the
environment through :class:`StepContext`.  This slice holds the
deterministic behaviours (secretion, chemotaxis, growth); the six that draw
random numbers come with ``prng.uniform`` / ``normal`` in the next slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from . import diffusion as dgrid
from . import prng
from .agents import AgentPool
from .neighbors import NeighborContext


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Per-iteration environment handed to each behavior (built by the
    scheduler's ``env_build`` op, threaded by the ``behaviors`` op).
    ``cand`` / ``cand_mask`` / ``src_*`` delegate to the lazy
    :class:`NeighborContext`."""

    rng: torch.Tensor            # (2,) uint32 key data
    grids: Dict[str, dgrid.DiffusionGrid]
    neighbors: NeighborContext
    dt: torch.Tensor             # () f32
    step: int
    min_bound: float
    max_bound: float

    @property
    def cand(self) -> torch.Tensor:
        return self.neighbors.cand

    @property
    def cand_mask(self) -> torch.Tensor:
        return self.neighbors.cand_mask

    @property
    def src_position(self) -> torch.Tensor:
        return self.neighbors.src_position

    @property
    def src_kind(self) -> torch.Tensor:
        return self.neighbors.src_kind

    def next_rng(self) -> Tuple["StepContext", torch.Tensor]:
        k1, k2 = prng.split(self.rng)
        return dataclasses.replace(self, rng=k1), k2

    def with_grid(self, name: str, grid: dgrid.DiffusionGrid) -> "StepContext":
        grids = dict(self.grids)
        grids[name] = grid
        return dataclasses.replace(self, grids=grids)


Behavior = Callable[[StepContext, AgentPool], Tuple[StepContext, AgentPool]]


def _kind_mask(pool: AgentPool, kind: Optional[int]) -> torch.Tensor:
    if kind is None:
        return pool.alive
    return pool.alive & (pool.kind == kind)


def chemotaxis(grid_name: str, weight: float, kind: Optional[int] = None) -> Behavior:
    """Algorithm 7: move along the normalized substance gradient."""

    def run(ctx: StepContext, pool: AgentPool):
        g = dgrid.gradient_at(ctx.grids[grid_name], pool.position, normalized=True)
        mask = _kind_mask(pool, kind)
        return ctx, pool.replace(
            position=pool.position + torch.where(mask[:, None], g * weight, 0.0)
        )

    return run


def secretion(grid_name: str, quantity: float, kind: Optional[int] = None) -> Behavior:
    """Algorithm 6: scatter-add substance at agent positions."""

    def run(ctx: StepContext, pool: AgentPool):
        mask = _kind_mask(pool, kind)
        grid = dgrid.increase_concentration(
            ctx.grids[grid_name], pool.position, quantity, mask=mask
        )
        return ctx.with_grid(grid_name, grid), pool

    return run


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no ``cbrt``); within an ulp or two of it."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def growth(rate: float, max_diameter: float, kind: Optional[int] = None) -> Behavior:
    """Algorithm 2 L9–10: volumetric growth until max diameter.

    ``rate`` is a volume increase per unit time (μm³/h in the paper)."""

    def run(ctx: StepContext, pool: AgentPool):
        d = pool.diameter
        vol = math.pi / 6.0 * d**3
        new_vol = vol + rate * ctx.dt
        new_d = _cbrt(6.0 * new_vol / math.pi)
        mask = _kind_mask(pool, kind) & (d < max_diameter)
        return ctx, pool.replace(
            diameter=torch.where(mask, torch.clamp(new_d, max=max_diameter), d)
        )

    return run
