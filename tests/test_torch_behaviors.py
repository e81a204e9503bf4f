"""The behaviours that draw random numbers, one step each, from the same pool
and the same key in both packages.

Every decision is exact: the masks of who divides, dies, gets infected or
recovers, the kinds, the alive flags and the slots the children take — the
port draws the reference's uniform bits.  Positions and diameters agree to
``atol=1e-5``: normal draws are within 3 ulp (tests/test_torch_prng.py) and
the port's cube root within 2 ulp of ``jnp.cbrt`` (pinned below; ROADMAP §3
records why that is not a fault).  Input diameters stay more than 1e-3 from
``trigger_diameter`` and ``max_diameter``, so no 2-ulp difference can flip
a division.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import agents as j_agents
from repro.core import grid as j_grid
from repro.core.behaviors import StepContext as JContext
from repro.core.neighbors import NeighborContext as JNeighbors
from repro_torch import core as tc
from repro_torch.core import agents as t_agents
from repro_torch.core import behaviors as t_behaviors
from repro_torch.core import grid as t_grid
from repro_torch.core import prng
from repro_torch.core.behaviors import StepContext as TContext
from repro_torch.core.neighbors import NeighborContext as TNeighbors
from torch_parity import CPU, to_np

ATOL = 1e-5
SPACE, BOX, CAP, N = 60.0, 6.0, 230, 220


def _away_from(x, marks, gap=2e-3):
    """Nudge values that sit within ``gap`` of a mark off it."""
    for m in marks:
        near = np.abs(x - m) < gap
        x[near] = m + np.where(x[near] >= m, gap, -gap)
    return x


def _start(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, SPACE, (N, 3)).astype(np.float32)
    diam = _away_from(rng.uniform(14.0, 18.0, N), (17.0, 18.0)).astype(np.float32)
    kind = rng.choice(3, N, p=[0.6, 0.3, 0.1]).astype(np.int32)
    age = rng.uniform(0.0, 100.0, CAP).astype(np.float32)
    alive = np.zeros(CAP, bool)
    alive[:N] = rng.random(N) < 0.95
    return pos, diam, kind, age, alive


def _contexts(seed):
    """Both packages' (StepContext, pool) over one start, key
    ``fold_in(PRNGKey(seed), 5)`` as the scheduler derives it."""
    pos, diam, kind, age, alive = _start(seed)
    common = dict(origin=(0.0, 0.0, 0.0), box_size=BOX, dims=(10, 10, 10), max_per_cell=24)
    jspec, tspec = j_grid.GridSpec(**common), t_grid.GridSpec(**common)
    jpool = j_agents.make_pool(CAP, jnp.asarray(pos), diameter=jnp.asarray(diam),
                               kind=jnp.asarray(kind))
    jpool = jpool.replace(age=jnp.asarray(age), alive=jnp.asarray(alive))
    tpool = t_agents.make_pool(CAP, pos, diameter=diam, kind=kind, device=CPU)
    tpool = tpool.replace(age=torch.from_numpy(age), alive=torch.from_numpy(alive))
    jidx, tidx = j_grid.build_index(jspec, jpool), t_grid.build_index(tspec, tpool)
    common = dict(grids={}, min_bound=0.0, max_bound=SPACE)
    jctx = JContext(rng=jax.random.fold_in(jax.random.PRNGKey(seed), 5),
                    neighbors=JNeighbors.for_pool(jspec, jidx, jpool),
                    dt=jnp.float32(1.0), step=jnp.int32(5), **common)
    tctx = TContext(rng=prng.fold_in(prng.PRNGKey(seed), 5),
                    neighbors=TNeighbors.for_pool(tspec, tidx, tpool),
                    dt=torch.tensor(1.0), step=5, **common)
    return (jctx, jpool), (tctx, tpool)


BEHAVIORS = {
    "brownian_motion": lambda lib: lib.brownian_motion(0.15),
    "random_movement": lambda lib: lib.random_movement(6.2, kind=1),
    "growth": lambda lib: lib.growth(60.0, 18.0),
    "cell_division": lambda lib: lib.cell_division(0.9, trigger_diameter=17.0),
    "apoptosis": lambda lib: lib.apoptosis(0.3, min_age=50.0),
    "sir_infection": lambda lib: lib.sir_infection(6.0, 0.8),
    "sir_recovery": lambda lib: lib.sir_recovery(0.3),
}


@pytest.mark.parametrize("name", sorted(BEHAVIORS))
def test_behavior_one_step_matches_jax(name):
    (jctx, jpool), (tctx, tpool) = _contexts(seed=sorted(BEHAVIORS).index(name))
    jctx2, jout = BEHAVIORS[name](jc)(jctx, jpool)
    tctx2, tout = BEHAVIORS[name](tc)(tctx, tpool)
    # The key chain: the behaviour consumed one split, as the reference.
    np.testing.assert_array_equal(to_np(tctx2.rng), to_np(jax.random.key_data(jctx2.rng)))
    for f in ("alive", "kind", "static", "overflow"):
        np.testing.assert_array_equal(to_np(getattr(tout, f)), to_np(getattr(jout, f)),
                                      err_msg=f)
    for f in ("position", "diameter", "age"):
        np.testing.assert_allclose(to_np(getattr(tout, f)), to_np(getattr(jout, f)),
                                   atol=ATOL, err_msg=f)
    # Each behaviour really acted on this input.
    before, after = to_np(tpool.alive), to_np(tout.alive)
    if name == "cell_division":
        born = after & ~before
        assert born.sum() > 5 and int(tout.overflow) > 0     # more spawns than slots
        shrunk = to_np(tout.diameter)[before] < to_np(tpool.diameter)[before]
        assert shrunk.sum() == born.sum() + int(tout.overflow)
    elif name == "apoptosis":
        assert 5 < (before & ~after).sum() and not (after & ~before).any()
    elif name in ("sir_infection", "sir_recovery"):
        changed = to_np(tout.kind) != to_np(tpool.kind)
        assert changed.sum() > 3
    elif name == "growth":
        assert (to_np(tout.diameter) > to_np(tpool.diameter)).sum() > 100
    else:
        moved = np.abs(to_np(tout.position) - to_np(tpool.position)).max(axis=1) > 0
        assert moved.sum() > 30


def test_cbrt_within_two_ulp_of_jnp_cbrt():
    """The port's cube root against ``jnp.cbrt`` on the growth step's inputs
    (6·V/π after one 60 µm³ step, diameters 14–18 µm): at most 2 ulp.  No
    torch formula is bit-exact with XLA:CPU's cbrt here (ROADMAP §3)."""
    d = np.random.default_rng(0).uniform(14.0, 18.0, 200_000).astype(np.float32)
    vol = np.float32(math.pi / 6.0) * d * d * d + np.float32(60.0)
    x = (np.float32(6.0) * vol / np.float32(math.pi)).astype(np.float32)
    want = to_np(jnp.cbrt(jnp.asarray(x))).view(np.int32).astype(np.int64)
    got = to_np(t_behaviors._cbrt(torch.from_numpy(x))).view(np.int32).astype(np.int64)
    ulps = np.abs(got - want)
    assert ulps.max() <= 2
    assert 0 < (ulps > 0).mean() < 0.05
