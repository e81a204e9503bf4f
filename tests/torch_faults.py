"""Model-level fault injectors of ``tests/faults.py`` for the port.

The same models and faults, built through ``repro_torch.Simulation`` on a
chosen device.  The file-level injectors (``corrupt_manifest``,
``truncate_arrays``, ...) touch only files; the port's tests import them
from ``faults`` as they are.
"""

import dataclasses

import numpy as np
import torch


def nan_bomb_op(at_step: int):
    """A scheduler op that overwrites agent 0's x-position with NaN from
    ``at_step`` on — registered via ``Simulation.op``."""

    def nan_bomb(ctx, state):
        pos = state.pool.position.clone()
        hit = state.step >= at_step
        pos[0, 0] = torch.where(hit, torch.nan, pos[0, 0])
        return dataclasses.replace(state, pool=state.pool.replace(position=pos))

    return nan_bomb


def nan_bomb_attr_op(attr: str = "nan_bomb_at"):
    """``nan_bomb_op`` with the trigger step carried by agent 0's ``attr``
    value: every session runs one model, and which sessions blow up (and
    when) is state — a per-slot override in a sweep, or a request param of
    the session server.  In a batch it runs once a session, on that
    session's state, so agent 0 is the session's own.  Declare the attr with
    a sentinel default (e.g. 2**30) so sessions without an override never
    trigger."""

    def nan_bomb(ctx, state):
        pos = state.pool.position.clone()
        hit = state.step >= state.pool.attrs[attr][0].to(state.step.dtype)
        pos[0, 0] = torch.where(hit, torch.nan, pos[0, 0])
        return dataclasses.replace(state, pool=state.pool.replace(position=pos))

    return nan_bomb


def dividing_sim(capacity: int, n0: int = 24, seed: int = 7,
                 division_probability: float = 0.4, space: float = 40.0,
                 device: str = "cpu"):
    """A facade model whose population roughly ×1.4s per step — any fixed
    capacity saturates within a few steps, tripping ``pool.overflow``."""
    from repro_torch import Simulation
    from repro_torch.core.behaviors import cell_division

    rng = np.random.RandomState(seed)
    pos = rng.uniform(5.0, space - 5.0, (n0, 3)).astype(np.float32)
    return (
        Simulation(space=space, cell_size=4.0, boundary="closed", dt=1.0,
                   capacity=capacity, seed=seed, device=device)
        .add_agents(position=pos, diameter=3.0)
        .use(cell_division(division_probability))
        .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32))
    )


def overfull_cell_sim(max_per_cell: int = 4, impl: str = "fused",
                      overflow_fallback: bool = True, space: float = 20.0,
                      device: str = "cpu"):
    """A facade model with 12 agents blobbed inside one neighbor-grid cell
    and a deliberately tiny ``max_per_cell`` — the cell list overflows every
    step, exercising the dense fallback and the health flag."""
    from repro_torch import Simulation
    from repro_torch.core import ForceParams

    rng = np.random.default_rng(9)
    spread = rng.uniform(2.0, space - 2.0, (30, 3)).astype(np.float32)
    # All 12 inside the single [8, 10)³ grid cell — guaranteed overflow.
    blob = rng.uniform(8.2, 9.8, (12, 3)).astype(np.float32)
    pos = np.concatenate([spread, blob])
    return (
        Simulation(space=space, cell_size=2.0, boundary="closed", dt=0.01,
                   capacity=64, max_per_cell=max_per_cell, seed=3, device=device)
        .add_agents(position=pos, diameter=1.6)
        .mechanics(ForceParams(), impl=impl, overflow_fallback=overflow_fallback)
    )
