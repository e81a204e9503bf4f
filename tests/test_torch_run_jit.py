"""The compiled run (``run_jit``, ``core/runner.py``) on the CPU.

On CPU tensors the runner calls each captured step body as a plain function,
so the host count, the firing patterns, the device flags, the speculation
and the rollback all run here.  The port's ``run_jit`` is held to its own
``run`` bit for bit (every state leaf and every observable row, by bytes),
and to the reference's ``run_jit`` at tests/test_torch_engine.py's
tolerances: alive flags, kinds, kind counts and health exact, positions
``atol=1e-4``, fields and the custom op's dose ``rtol=1e-5``.

Each predicate of the force pass is made to flip mid-run by a custom op of
tests/torch_jit_cases.py (its JAX twin is here): a cell that overflows
``max_per_cell``, a Morton window that stops covering, an active set past
``active_capacity``; each run must roll back at least once.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro import Simulation as JSimulation
from repro.core.schedule import Scheduler as JScheduler
from repro_torch import Simulation as TSimulation
from repro_torch import convert
from repro_torch import core as tc
from repro_torch.core import behaviors as t_behaviors
from repro_torch.core import forces as t_forces
from repro_torch.core import grid as t_grid
from torch_force_cases import force_inputs
from torch_parity import jax_state_to_numpy, to_np
import torch_jit_cases as J

STEPS = 8
ATOL, RTOL = 1e-4, 1e-5


def _port_state(jstate, step=0):
    d = jax_state_to_numpy(jstate)
    d["step"] = step
    return convert.state_from_numpy(d, "cpu")


def _assert_close_to_jax(tobs, jobs, tfinal, jfinal):
    assert set(tobs) == set(jobs)
    for name in tobs:
        t, j = to_np(tobs[name]), to_np(jobs[name])
        assert t.shape == j.shape, name
        if t.dtype.kind in "biu":
            np.testing.assert_array_equal(t, j, err_msg=name)
        elif name == "position":
            np.testing.assert_allclose(t, j, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, err_msg=name)
    for f in ("alive", "kind", "overflow"):
        np.testing.assert_array_equal(to_np(getattr(tfinal.pool, f)),
                                      to_np(getattr(jfinal.pool, f)), err_msg=f)
    np.testing.assert_allclose(to_np(tfinal.pool.position), to_np(jfinal.pool.position),
                               atol=ATOL)
    assert int(tfinal.step) == int(jfinal.step)
    np.testing.assert_array_equal(to_np(tfinal.rng), jax_state_to_numpy(jfinal)["rng"])
    for f in dataclasses.fields(tfinal.health):
        assert int(getattr(tfinal.health, f.name)) == int(getattr(jfinal.health, f.name)), f


def _both_runs(tbuilt, state, steps):
    """The port's ``run`` and ``run_jit`` from ``state``, bit for bit equal;
    returns the run_jit result and the runner's counts."""
    eager = tbuilt.run(steps, state=state)
    jit = tbuilt.run_jit(steps, state=state)
    J.assert_runs_bit_equal(eager, jit)
    return jit, dict(tbuilt._jitted.stats)


# ------------------------------------------- (a), (b): the engine model

def _declare(pkg, lib, xp, diffusion=4.0, **sim_kw):
    """tests/test_torch_engine.py's model (tests/torch_jit_cases.py's soma)
    through one package's facade; ``diffusion``: both substances'
    coefficient."""
    n, space, res = 120, 100.0, 20

    def exposure_op(ctx, state):
        pool = state.pool
        c0 = lib.concentration_at(state.grids["substance_0"], pool.position)
        c1 = lib.concentration_at(state.grids["substance_1"], pool.position)
        own = xp.where(pool.kind == 0, c0, c1)
        dose = xp.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    def fields(state):
        return xp.stack([state.grids["substance_0"].concentration,
                         state.grids["substance_1"].concentration])

    rng = np.random.default_rng(0)
    pos = rng.uniform(10, space - 10, (n, 3)).astype(np.float32)
    kind = (rng.random(n) < 0.5).astype(np.int32)
    c0, c1 = J.ramp_fields(res)
    return (
        pkg(space=(0.0, space), cell_size=10.0, boundary="closed", dt=1.0,
            max_per_cell=64, seed=0, **sim_kw)
        .add_agents(n, position=pos, diameter=5.0, kind=kind, exposure=0.0)
        .add_substance("substance_0", diffusion=diffusion, decay=0.002, resolution=res,
                       concentration=c0)
        .add_substance("substance_1", diffusion=diffusion, decay=0.002, resolution=res,
                       concentration=c1)
        .use(lib.secretion("substance_0", 1.0, kind=0),
             lib.secretion("substance_1", 1.0, kind=1),
             lib.chemotaxis("substance_0", 0.75, kind=0),
             lib.chemotaxis("substance_1", 0.75, kind=1))
        .op(exposure_op, name="exposure", phase="post")
        .observe("position", lambda s: s.pool.position)
        .observe("fields", fields)
        .observe("exposure", lambda s: s.pool.get("exposure"))
        .observe_kinds(frequency=3)
    )


def _engine_pair(diffusion=4.0, kernels=True, **sim_kw):
    """The engine model built in both packages: with ``kernels``, fused
    forces and the Pallas rank and diffusion (interpret mode) in the
    reference, the same kernels' plain versions in the port; else the
    reference impls in both."""
    force, diff = ("fused", "pallas") if kernels else ("reference", "reference")
    sim = _declare(JSimulation, jc, jnp, diffusion, **sim_kw).mechanics(
        jc.ForceParams(), impl=force, diffusion_impl=diff)
    jbuilt = sim.build()
    if kernels:
        cfg = dataclasses.replace(
            jbuilt.config, spec=dataclasses.replace(jbuilt.config.spec, rank_impl="pallas"))
        jbuilt = dataclasses.replace(
            jbuilt, config=cfg, scheduler=sim._apply_custom_ops(JScheduler.default(cfg)))
    tsim = _declare(TSimulation, tc, torch, diffusion, device="cpu",
                    rank_impl="cuda" if kernels else "tiled", **sim_kw)
    tbuilt = tsim.mechanics(tc.ForceParams(), impl=force,
                            diffusion_impl="cuda" if kernels else "reference").build()
    return jbuilt, tbuilt


def test_engine_model_matches_run_and_the_reference():
    """(a) 8 steps of the engine model, kind counts every 3 steps."""
    jbuilt, tbuilt = _engine_pair()
    jfinal, jobs = jbuilt.run_jit(STEPS)
    (tfinal, tobs), stats = _both_runs(tbuilt, _port_state(jbuilt.state), STEPS)
    _assert_close_to_jax(tobs, jobs, tfinal, jfinal)
    assert to_np(tobs["kind_counts"]).shape == (3, 2)
    # Kinds fire at 0, 3, 6 and sort at 0: three patterns, one graph each.
    assert stats["graphs"] == 3 and stats["replays"] == STEPS - 3
    assert stats["rollbacks"] == 0


def test_frequencies_and_a_gated_observable_from_an_odd_start():
    """(b) sort every 2, diffusion every 3 and kind counts every 3, from
    step 1: the patterns, the gates and the gated rows follow the host
    count, and the series keeps the firings inside the window.  (A
    coefficient of 1 keeps the 3-step diffusion stable: dx² / 6ν = 4.2;
    the reference impls, whose compile is cheap: (a) has the kernels.)"""
    jbuilt, tbuilt = _engine_pair(1.0, kernels=False, sort_frequency=2,
                                  diffusion_frequency=3)
    jstate = dataclasses.replace(jbuilt.state, step=jnp.asarray(1, jnp.int32))
    jfinal, jobs = jbuilt.run_jit(STEPS, state=jstate)
    (tfinal, tobs), stats = _both_runs(tbuilt, _port_state(jbuilt.state, step=1), STEPS)
    _assert_close_to_jax(tobs, jobs, tfinal, jfinal)
    assert to_np(tobs["kind_counts"]).shape == (2, 2)          # steps 3 and 6
    assert stats["graphs"] >= 4 and stats["replays"] >= 2 and stats["rollbacks"] == 0
    # A second run of the same runner replays the graphs it holds.
    again = tbuilt.run_jit(STEPS, state=_port_state(jbuilt.state, step=1))
    J.assert_runs_bit_equal((tfinal, tobs), again)
    assert tbuilt._jitted.stats["graphs"] == stats["graphs"]


# ------------------------------------------- (c): predicates that flip

def _jax_crowd_op(rows, at_step, point):
    def crowd(ctx, state):
        pos = state.pool.position
        head = jnp.where(state.step >= at_step, point, pos[:rows])
        return dataclasses.replace(
            state, pool=state.pool.replace(position=jnp.concatenate([head, pos[rows:]])))
    return crowd


def _jax_kick_op(at_step, p, q):
    pq = jnp.asarray([p, q], jnp.float32)

    def kick(ctx, state):
        pos = state.pool.position
        head = jnp.where(state.step >= at_step, pq, pos[:2])
        return dataclasses.replace(
            state, pool=state.pool.replace(position=jnp.concatenate([head, pos[2:]])))
    return kick


def _jax_nudge_op(rows, at_step, dx):
    def nudge(ctx, state):
        pos = state.pool.position
        head = pos[:rows].at[:, 0].add(jnp.where(state.step >= at_step, dx, 0.0))
        return dataclasses.replace(
            state, pool=state.pool.replace(position=jnp.concatenate([head, pos[rows:]])))
    return nudge


def _flip_run(declare, op_pair, steps=STEPS, **mechanics):
    """One model in both packages with a flipping op; the port's run_jit
    against its run and the reference's run_jit."""
    jop, top = op_pair
    jsim = declare(JSimulation, jc).mechanics(jc.ForceParams(), **mechanics)
    jsim.op(jop, name="flip", phase="agent")
    jbuilt = jsim.observe("position", lambda s: s.pool.position).build()
    tsim = declare(TSimulation, tc, device="cpu").mechanics(tc.ForceParams(), **mechanics)
    tsim.op(top, name="flip", phase="agent")
    tbuilt = tsim.observe("position", lambda s: s.pool.position).build()
    jfinal, jobs = jbuilt.run_jit(steps)
    (tfinal, tobs), stats = _both_runs(tbuilt, _port_state(jbuilt.state), steps)
    _assert_close_to_jax(tobs, jobs, tfinal, jfinal)
    assert stats["rollbacks"] >= 1 and stats["replays"] >= 1
    return tbuilt, tfinal, tobs, stats


def _sparse(pkg, lib, n=60, space=40.0, cell=5.0, m=4, diameter=3.0, seed=3, **kw):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(2.0, space - 2.0, (n, 3)).astype(np.float32)
    return (pkg(space=(0.0, space), cell_size=cell, boundary="closed", dt=1.0,
                max_per_cell=m, seed=0, **kw)
            .add_agents(n, position=pos, diameter=diameter)
            .use(lib.brownian_motion(0.2)))


def test_a_cell_that_overflows_mid_run_rolls_back():
    """(c) 5 rows stacked in one box in step 3 (``max_per_cell`` 4): from
    step 4 the fused pass falls back to the dense candidates."""
    tbuilt, tfinal, _, _ = _flip_run(
        _sparse, (_jax_crowd_op(5, 3, 20.0), J.crowd_op(5, 3, 20.0)), impl="fused")
    assert int(tfinal.health.cell_overflow_steps) == STEPS - 4
    assert any(dict(k[1]).get("overflowed") for k in tbuilt._jitted._graphs)


# Two Z-aligned octets of 20 agents each, and the kicked pair P, Q in the
# boxes (0, 0, 7) and (0, 0, 8) on either side of the top z seam of a 16^3
# grid of 4-unit boxes: in Z-order P < octet B < octet A < Q.
_P, _Q = (2.0, 2.0, 30.0), (2.0, 2.0, 34.0)


def _octets(pkg, lib, device=None, **kw):
    rng = np.random.default_rng(5)
    a = rng.uniform((33, 33, 1), (39, 39, 7), (20, 3))
    b = rng.uniform((33, 1, 25), (39, 7, 31), (20, 3))
    pos = np.concatenate([a, b]).astype(np.float32)
    kw = dict(kw, device=device) if device else kw
    return (pkg(space=(0.0, 64.0), cell_size=4.0, boundary="closed", dt=1.0, capacity=48,
                max_per_cell=16, seed=0, sort_frequency=1, **kw)
            .add_agents(40, position=pos, diameter=1.0))


def _covering_window(block):
    built = _octets(TSimulation, tc, device="cpu").build()
    spec = built.config.spec
    pool = t_grid.sort_agents(spec, built.state.pool)
    return t_forces.covering_half_window(
        spec, t_grid.build_index(spec, pool, assume_sorted=True), block)


def test_a_morton_window_that_stops_covering_rolls_back():
    """(c) The window covers both octets; from step 3 the kicked pair's
    boxes touch across the top seam, a whole pool of rows apart, and the
    coverage gate sends the pass to the linear kernel."""
    w = _covering_window(4) + 1
    assert w < 10                         # a pool of 48 rows is 12 blocks
    tbuilt, _, _, stats = _flip_run(
        _octets, (_jax_kick_op(3, _P, _Q), J.kick_op(3, _P, _Q)), impl="fused",
        tile_order="morton", morton_block=4, morton_window=w)
    keys = [dict(k[1]) for k in tbuilt._jitted._graphs]
    assert {k["window"] for k in keys} == {True, False}


def _resting(pkg, lib, **kw):
    """40 agents of diameter 1 that never touch, and no motion of their own."""
    pos = np.random.default_rng(4).uniform(2.0, 38.0, (40, 3)).astype(np.float32)
    return (pkg(space=(0.0, 40.0), cell_size=5.0, boundary="closed", dt=1.0,
                max_per_cell=16, seed=0, **kw)
            .add_agents(40, position=pos, diameter=1.0))


def test_an_active_set_past_active_capacity_rolls_back():
    """(c) Sparse agents at rest go static after step 0 (the active set
    falls under ``active_capacity`` 8); from step 3 twelve are nudged every
    step and the set exceeds it again."""
    tbuilt, _, _, stats = _flip_run(
        _resting, (_jax_nudge_op(12, 3, 0.01), J.nudge_op(12, 3, 0.01)), impl="fused",
        active_capacity=8)
    crowded = {dict(k[1])["crowded"] for k in tbuilt._jitted._graphs}
    assert crowded == {True, False}


# ------------------------------------------- (d), (e): what raises

def test_a_negative_cell_id_raises_as_run_does():
    """(d) From step 3 the index carries negative cell ids: the Morton pass
    refuses them in run, and run_jit rolls the diverged chunk back and
    raises the same ValueError at the same step."""
    sim = _octets(TSimulation, tc, device="cpu").mechanics(
        tc.ForceParams(), impl="fused", tile_order="morton", morton_block=4,
        morton_window=11)
    sim.op(J.negative_id_op(3), name="corrupt", phase="pre")
    built = sim.build()
    with pytest.raises(ValueError, match="cell ids must be >= 0") as eager:
        built.run(STEPS)
    with pytest.raises(ValueError, match="cell ids must be >= 0") as jit:
        built.run_jit(STEPS)
    assert str(jit.value) == str(eager.value)
    stats = built._jitted.stats
    assert stats["rollbacks"] == 1 and stats["replays"] >= 2


def test_count_kinds_without_n_kinds_raises_under_run_jit():
    """(e) The kind count sizes its output: neither package derives it
    inside a compiled run."""
    jbuilt, tbuilt = _engine_pair(kernels=False)
    with pytest.raises(ValueError, match="n_kinds"):
        jc.run_jit(jbuilt.config, jbuilt.state, 3, collect=jc.count_kinds)
    with pytest.raises(ValueError, match="n_kinds"):
        tc.run_jit(tbuilt.config, tbuilt.state, 3, collect=tc.count_kinds)
    counts = functools.partial(tc.count_kinds, n_kinds=2)
    J.assert_runs_bit_equal(tc.run(tbuilt.config, tbuilt.state, 3, collect=counts),
                            tc.run_jit(tbuilt.config, tbuilt.state, 3, collect=counts))


# ------------------------------------------- (f): the masked forms

@pytest.mark.parametrize("tile_slots", [None, 1000])
def test_masked_forces_equal_the_nonzero_form(monkeypatch, tile_slots):
    """(f) Every slot evaluated and the masked-out ones zeroed, in one tile
    or many, sums each row to the same bits as the gathered slots."""
    if tile_slots:
        monkeypatch.setattr(t_forces, "MASKED_TILE_SLOTS", tile_slots)
    pos, rad, index, spec, cap = force_inputs("generic")
    pool = tc.make_pool(cap, pos, diameter=2.0 * rad)
    cand, mask = t_grid.candidate_neighbors(spec, index, pool)
    assert int(mask.sum()) > 100
    params = tc.ForceParams()
    want = t_forces.forces_from_candidates(pos, rad, cand, mask, params)
    got = t_forces.forces_from_candidates(pos, rad, cand, mask, params, masked=True)
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("tile_slots", [None, 1000])
def test_masked_infection_equals_the_nonzero_form(monkeypatch, tile_slots):
    if tile_slots:
        monkeypatch.setattr(t_forces, "MASKED_TILE_SLOTS", tile_slots)
    pos, rad, index, spec, cap = force_inputs("generic")
    pool = tc.make_pool(cap, pos, diameter=2.0 * rad)
    cand, mask = t_grid.candidate_neighbors(spec, index, pool)
    kind = torch.from_numpy(np.random.default_rng(1).integers(0, 3, cap).astype(np.int32))
    args = (pos, cand, mask, pos, kind, 2.5)
    want = t_behaviors.infected_nearby(*args)
    assert 0 < int(want.sum()) < cap
    assert torch.equal(t_behaviors.infected_nearby_masked(*args), want)
