"""The slice as a whole: the soma-clustering model of examples/quickstart.py
(paper §4.7.1) at its ``--smoke`` size, 120 agents in 10³ boxes with two
20³ substances, with every kernel of the slice switched on in both packages.

JAX runs ``force_impl="fused"``, ``diffusion_impl="pallas"`` and the Pallas
``cell_rank`` (its facade cannot pass ``rank_impl``, so the test swaps the
spec before ``Scheduler.default``), all in interpret mode.  The port runs
the same impls on the CPU (the kernels' plain versions) from the JAX
initial state carried across by ``repro_torch.convert``.

Tolerances: cell lists and kind counts exact; positions ``atol=1e-4`` (the
reference's own between its force impls, tests/test_cell_force.py); fields
and the custom op's dose ``rtol=1e-5``.  The fields start from smooth ramps
so that chemotaxis never normalises a gradient near zero, where one ulp
would turn the direction.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import torch

import repro.core as jc
from repro import Simulation as JSimulation
from repro.core import grid as j_grid
from repro.core.schedule import Scheduler as JScheduler
from repro_torch import Simulation as TSimulation
from repro_torch import convert
from repro_torch import core as tc
from repro_torch.core import grid as t_grid
from torch_parity import jax_state_to_numpy, to_np

N, SPACE, RES, STEPS = 120, 100.0, 20, 8


def _fields():
    i, j, k = np.meshgrid(*[np.arange(RES, dtype=np.float32)] * 3, indexing="ij")
    return ((2.0 + 0.6 * i + 0.4 * j + 0.2 * k).astype(np.float32),
            (2.0 + 0.1 * i + 0.3 * j + 0.2 * k).astype(np.float32))


def _declare(pkg, lib, xp, **sim_kw):
    """The quickstart model, declared through one package's facade."""

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
    pos = rng.uniform(10, SPACE - 10, (N, 3)).astype(np.float32)
    kind = (rng.random(N) < 0.5).astype(np.int32)
    c0, c1 = _fields()
    return (
        pkg(space=(0.0, SPACE), cell_size=10.0, boundary="closed", dt=1.0,
            max_per_cell=64, seed=0, **sim_kw)
        .add_agents(N, position=pos, diameter=5.0, kind=kind, exposure=0.0)
        .add_substance("substance_0", diffusion=4.0, decay=0.002, resolution=RES,
                       concentration=c0)
        .add_substance("substance_1", diffusion=4.0, decay=0.002, resolution=RES,
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


@functools.lru_cache(maxsize=None)
def _jax():
    sim = _declare(JSimulation, jc, jnp).mechanics(
        jc.ForceParams(), impl="fused", diffusion_impl="pallas")
    built = sim.build()
    cfg = dataclasses.replace(
        built.config, spec=dataclasses.replace(built.config.spec, rank_impl="pallas"))
    built = dataclasses.replace(
        built, config=cfg, scheduler=sim._apply_custom_ops(JScheduler.default(cfg)))
    final, obs = built.run(STEPS)
    return built, final, {k: to_np(v) for k, v in obs.items()}


@functools.lru_cache(maxsize=None)
def _port():
    jbuilt = _jax()[0]
    sim = _declare(TSimulation, tc, torch, rank_impl="cuda", device="cpu").mechanics(
        tc.ForceParams(), impl="fused", diffusion_impl="cuda")
    built = sim.build()
    state0 = convert.state_from_numpy(jax_state_to_numpy(jbuilt.state), "cpu")
    final, obs = built.run(STEPS, state=state0)
    return built, state0, final, {k: to_np(v) for k, v in obs.items()}


def test_schedules_and_initial_states_agree():
    jbuilt = _jax()[0]
    tbuilt, state0, *_ = _port()
    assert tbuilt.scheduler.op_names() == jbuilt.scheduler.op_names()
    assert [o.name for o in tbuilt.scheduler.ordered_ops()] == \
        [o.name for o in jbuilt.scheduler.ordered_ops()]
    assert tbuilt.config.spec.rank_impl == "cuda" and tbuilt.config.force_impl == "fused"
    # The port's own facade builds the state that convert carries across.
    own, carried = convert.state_to_numpy(tbuilt.state), convert.state_to_numpy(state0)
    for f, v in carried["pool"].items():
        if f != "attrs":
            np.testing.assert_array_equal(own["pool"][f], v, err_msg=f)
    np.testing.assert_array_equal(own["pool"]["attrs"]["exposure"],
                                  carried["pool"]["attrs"]["exposure"])
    for name, g in carried["grids"].items():
        np.testing.assert_array_equal(own["grids"][name]["concentration"], g["concentration"])
        assert own["grids"][name]["spacing"] == g["spacing"]
    np.testing.assert_array_equal(own["rng"], carried["rng"])
    assert own["step"] == carried["step"] == 0


def test_cell_lists_at_step_zero_are_exact():
    jbuilt = _jax()[0]
    tbuilt, state0, *_ = _port()
    jspec, tspec = jbuilt.config.spec, tbuilt.config.spec
    jpool = j_grid.sort_agents(jspec, jbuilt.state.pool)
    tpool = t_grid.sort_agents(tspec, state0.pool)
    np.testing.assert_array_equal(to_np(tpool.position), to_np(jpool.position))
    jidx, tidx = j_grid.build_index(jspec, jpool), t_grid.build_index(tspec, tpool)
    for f in ("cell_of_agent", "cell_list", "cell_count", "overflowed"):
        np.testing.assert_array_equal(to_np(getattr(tidx, f)), to_np(getattr(jidx, f)),
                                      err_msg=f)


def test_trajectory_matches_jax():
    _, jfinal, jobs = _jax()
    _, _, tfinal, tobs = _port()
    assert set(tobs) == set(jobs)
    assert tobs["position"].shape == (STEPS, N, 3)
    np.testing.assert_allclose(tobs["position"], jobs["position"], atol=1e-4)
    np.testing.assert_allclose(tobs["fields"], jobs["fields"], rtol=1e-5)
    np.testing.assert_allclose(tobs["exposure"], jobs["exposure"], rtol=1e-5)
    np.testing.assert_array_equal(tobs["kind_counts"], jobs["kind_counts"])
    assert tobs["kind_counts"].shape == (3, 2)          # ⌈8/3⌉ firings
    # The agents moved, the custom op fired, and the final states agree.
    assert np.abs(tobs["position"][-1] - tobs["position"][0]).max() > 0.5
    assert (tobs["exposure"][-1] > 0).all()
    np.testing.assert_array_equal(to_np(tfinal.pool.alive), to_np(jfinal.pool.alive))
    assert int(tfinal.step) == int(jfinal.step) == STEPS
    np.testing.assert_array_equal(to_np(tfinal.rng), to_np(jax_state_to_numpy(jfinal)["rng"]))
    for f in dataclasses.fields(tfinal.health):
        assert int(getattr(tfinal.health, f.name)) == int(getattr(jfinal.health, f.name)) == 0
