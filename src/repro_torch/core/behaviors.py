"""Agent behaviors (§4.2.1, Appendix D).

Port of ``repro.core.behaviors``.  A behavior is a function
``(ctx, pool) -> (ctx, pool)`` over all agents at once; it reads the
environment through :class:`StepContext`.  The behaviours that draw random
numbers split the same keys and draw the same shapes as the reference, so
that with ``prng``'s bit-exact ``uniform`` every decision (divide, die,
infect, recover) is the reference's; ``normal`` directions agree to 3 ulp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import diffusion as dgrid
from . import prng
from .agents import AgentPool, add_agents, remove_agents
from .neighbors import NeighborContext


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Per-iteration environment handed to each behavior (built by the
    scheduler's ``env_build`` op, threaded by the ``behaviors`` op).
    ``cand`` / ``cand_mask`` / ``src_*`` delegate to the lazy
    :class:`NeighborContext`.  In a batch's step (``core/slots.py``) the
    pool is the flat view of B sessions and ``rng`` a (B, 2) key batch:
    ``next_rng`` splits every session's key, and the draws of ``prng`` give
    each session its solo draws."""

    rng: torch.Tensor            # (2,) uint32 key data; (B, 2) in a batch
    grids: Dict[str, dgrid.DiffusionGrid]
    neighbors: NeighborContext
    dt: torch.Tensor             # () f32
    step: Any                    # the counter; a tuple, one a session, in a batch
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


def _unit(v: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` scaled to unit length (zero rows stay zero)."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=1e-12)


# ------------------------------------------------------------------ motion

def brownian_motion(rate: float, kind: Optional[int] = None) -> Behavior:
    """Tumor-spheroid random migration (Algorithm 2 L1–3): unit random
    direction scaled by the displacement rate."""

    def run(ctx: StepContext, pool: AgentPool):
        ctx, key = ctx.next_rng()
        step = _unit(prng.normal(key, pool.position.shape)) * rate
        mask = _kind_mask(pool, kind)
        return ctx, pool.replace(
            position=pool.position + torch.where(mask[:, None], step, 0.0)
        )

    return run


def random_movement(max_step: float, kind: Optional[int] = None) -> Behavior:
    """SIR random movement (Algorithm 5): uniform vector with clamped length."""

    def run(ctx: StepContext, pool: AgentPool):
        ctx, key = ctx.next_rng()
        vec = prng.uniform(key, pool.position.shape, minval=-1.0, maxval=1.0)
        step = _unit(vec) * max_step
        mask = _kind_mask(pool, kind)
        return ctx, pool.replace(
            position=pool.position + torch.where(mask[:, None], step, 0.0)
        )

    return run


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
    """Real cube root (torch has no ``cbrt``).  Within 2 ulp of ``jnp.cbrt``
    on the growth step's inputs (1.4% of them differ); no torch formula is
    bit-exact with XLA here (ROADMAP §3)."""
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


def cell_division(
    division_probability: float,
    trigger_diameter: Optional[float] = None,
    kind: Optional[int] = None,
    volume_split: float = 0.5,
    separation: float = 0.5,
) -> Behavior:
    """Algorithm 2 L11–12: divide into two daughters.  The mother keeps
    ``volume_split`` of the volume; the daughter appears in a random
    direction at ``separation``·radius.  New agents become visible to
    neighbour queries next iteration (§4.4.2)."""

    def run(ctx: StepContext, pool: AgentPool):
        ctx, key = ctx.next_rng()
        k_prob, k_dir = prng.split(key)
        u = prng.uniform(k_prob, (pool.capacity,))
        mask = _kind_mask(pool, kind) & (u < division_probability)
        if trigger_diameter is not None:
            mask = mask & (pool.diameter >= trigger_diameter)

        vol = math.pi / 6.0 * pool.diameter**3
        d_mother = _cbrt(6.0 * vol * volume_split / math.pi)
        d_child = _cbrt(6.0 * vol * (1.0 - volume_split) / math.pi)
        direction = _unit(prng.normal(k_dir, pool.position.shape))
        child_pos = pool.position + direction * (separation * 0.5 * pool.diameter)[:, None]

        pool = pool.replace(diameter=torch.where(mask, d_mother, pool.diameter))
        pool = add_agents(pool, spawn_mask=mask, position=child_pos,
                          diameter=d_child, kind=pool.kind)
        return ctx, pool

    return run


def apoptosis(death_probability: float, min_age: float = 0.0,
              kind: Optional[int] = None) -> Behavior:
    """Algorithm 2 L4–7: stochastic death after a minimum age."""

    def run(ctx: StepContext, pool: AgentPool):
        ctx, key = ctx.next_rng()
        u = prng.uniform(key, (pool.capacity,))
        mask = _kind_mask(pool, kind) & (pool.age >= min_age) & (u < death_probability)
        return ctx, remove_agents(pool, mask)

    return run


# ---------------------------------------------------------------- SIR model

SUSCEPTIBLE, INFECTED, RECOVERED = 0, 1, 2


def infected_nearby(position, cand, cand_mask, src_position, src_kind,
                    infection_radius: float) -> torch.Tensor:
    """(N,) bool: has the agent an infected candidate within the radius?
    Over the masked-in candidate slots only (most slots are empty)."""
    rows, cols = cand_mask.nonzero(as_tuple=True)
    src = cand[rows, cols].long()
    dist2 = ((position[rows] - src_position[src]) ** 2).sum(dim=-1)
    close_infected = (src_kind[src] == INFECTED) & (dist2 <= infection_radius**2)
    exposed = torch.zeros(cand.shape[:1], dtype=torch.bool, device=cand.device)
    exposed[rows[close_infected]] = True
    return exposed


def infected_nearby_masked(position, cand, cand_mask, src_position, src_kind,
                           infection_radius: float) -> torch.Tensor:
    """:func:`infected_nearby` over every slot, in row tiles, for a step
    captured in a CUDA graph.  Each distance is summed over the same (·, 3)
    rows as there, so each decision is the same."""
    from .forces import masked_row_tile

    n, k = cand.shape
    tile = masked_row_tile(n, k)
    outs = []
    for i in range(0, n, tile):
        mask = cand_mask[i:i + tile]
        src = torch.where(mask, cand[i:i + tile], 0).long()
        d = position[i:i + tile, None, :] - src_position[src]
        dist2 = (d ** 2).reshape(-1, 3).sum(dim=-1).reshape(src.shape)
        close = mask & (src_kind[src] == INFECTED) & (dist2 <= infection_radius**2)
        outs.append(close.any(dim=1))
    if not outs:
        return torch.zeros((0,), dtype=torch.bool, device=cand.device)
    return torch.cat(outs)


def sir_infection(infection_radius: float, infection_probability: float) -> Behavior:
    """Algorithm 3, pull formulation (§2.1.1): a susceptible agent infects
    itself when an infected agent is within the infection radius."""

    def run(ctx: StepContext, pool: AgentPool):
        ctx, key = ctx.next_rng()
        u = prng.uniform(key, (pool.capacity,))
        if ctx.neighbors.masked:
            exposed = infected_nearby_masked(pool.position, ctx.cand, ctx.cand_mask,
                                             ctx.src_position, ctx.src_kind,
                                             infection_radius)
        else:
            exposed = infected_nearby(pool.position, ctx.cand, ctx.cand_mask,
                                      ctx.src_position, ctx.src_kind, infection_radius)
        becomes = (pool.alive & (pool.kind == SUSCEPTIBLE) & exposed
                   & (u < infection_probability))
        return ctx, pool.replace(kind=torch.where(becomes, INFECTED, pool.kind))

    return run


def sir_recovery(recovery_probability: float) -> Behavior:
    """Algorithm 4: infected → recovered with fixed probability per step."""

    def run(ctx: StepContext, pool: AgentPool):
        ctx, key = ctx.next_rng()
        u = prng.uniform(key, (pool.capacity,))
        becomes = pool.alive & (pool.kind == INFECTED) & (u < recovery_probability)
        return ctx, pool.replace(kind=torch.where(becomes, RECOVERED, pool.kind))

    return run
