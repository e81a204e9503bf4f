"""Particle swarm optimization (§4.4.10 parameter optimization).

The paper calibrates the epidemiology model's free parameters (infection
radius, infection probability, movement) with PSO against the analytical SIR
solution.  A copy of the reference's ``repro.optim.pso`` (numpy only): the
same configuration, the same draws from ``np.random.default_rng(seed)`` in
the same order, so both give the same swarm on the same objective
(standard global-best PSO, Kennedy & Eberhart)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PSOConfig:
    n_particles: int = 12
    inertia: float = 0.7
    cognitive: float = 1.5
    social: float = 1.5
    seed: int = 0


def optimize(
    objective: Callable[[np.ndarray], float],
    bounds: Sequence[Tuple[float, float]],
    n_iters: int = 20,
    config: PSOConfig | None = None,
    verbose: bool = False,
) -> Tuple[np.ndarray, float, list]:
    """Minimize ``objective`` over box ``bounds``: ``n_particles`` evaluations
    to start, then ``n_particles`` an iteration, one particle at a time.

    Returns (best_position, best_value, history)."""
    cfg = config or PSOConfig()
    rng = np.random.default_rng(cfg.seed)
    lo = np.asarray([b[0] for b in bounds], np.float64)
    hi = np.asarray([b[1] for b in bounds], np.float64)
    dim = len(bounds)

    pos = rng.uniform(lo, hi, (cfg.n_particles, dim))
    vel = rng.uniform(-(hi - lo), hi - lo, (cfg.n_particles, dim)) * 0.1
    pbest = pos.copy()
    pbest_val = np.array([objective(p) for p in pos])
    g = int(np.argmin(pbest_val))
    gbest, gbest_val = pbest[g].copy(), float(pbest_val[g])
    history = [gbest_val]

    for it in range(n_iters):
        r1 = rng.random((cfg.n_particles, dim))
        r2 = rng.random((cfg.n_particles, dim))
        vel = (
            cfg.inertia * vel
            + cfg.cognitive * r1 * (pbest - pos)
            + cfg.social * r2 * (gbest[None] - pos)
        )
        pos = np.clip(pos + vel, lo, hi)
        vals = np.array([objective(p) for p in pos])
        improved = vals < pbest_val
        pbest[improved] = pos[improved]
        pbest_val[improved] = vals[improved]
        g = int(np.argmin(pbest_val))
        if pbest_val[g] < gbest_val:
            gbest, gbest_val = pbest[g].copy(), float(pbest_val[g])
        history.append(gbest_val)
        if verbose:
            print(f"pso iter {it}: best {gbest_val:.6f} at {gbest}")
    return gbest, gbest_val, history
