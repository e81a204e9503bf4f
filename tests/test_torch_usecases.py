"""The use-case models on the port against the JAX reference, from one start.

Each model is declared through both facades (the port's builders live in
tests/torch_usecases.py, the reference's custom ops come from ``examples/``);
the reference's initial state is carried across by
``repro_torch.convert.state_from_numpy`` and both run the same steps.

Tolerances: alive flags, kinds and ``observe_kinds`` counts exact (the port
draws the reference's uniform bits); positions and float attributes
``atol=1e-4``, as the reference holds its own force impls
(tests/test_cell_force.py:193-195).
"""

import dataclasses
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np

import repro.core as jc
from repro import Simulation as JSimulation
from repro_torch import convert
from torch_parity import jax_state_to_numpy, to_np
import torch_usecases as U

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

ATOL = 1e-4


def _run_port(tsim, jstate, steps):
    tbuilt = tsim.build()
    state0 = convert.state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    final, obs = tbuilt.run(steps, state=state0)
    return tbuilt, state0, final, {k: to_np(v) for k, v in obs.items()}


def _assert_same_run(jfinal, jobs, tfinal, tobs, float_attrs=()):
    assert set(tobs) == set(jobs)
    np.testing.assert_array_equal(tobs["alive"], jobs["alive"])
    np.testing.assert_array_equal(tobs["kind"], jobs["kind"])
    np.testing.assert_array_equal(tobs["kind_counts"], jobs["kind_counts"])
    np.testing.assert_allclose(tobs["position"], jobs["position"], atol=ATOL)
    for f in ("overflow", "alive", "kind", "static"):
        np.testing.assert_array_equal(to_np(getattr(tfinal.pool, f)),
                                      to_np(getattr(jfinal.pool, f)), err_msg=f)
    np.testing.assert_allclose(to_np(tfinal.pool.diameter), to_np(jfinal.pool.diameter),
                               atol=ATOL)
    for name in float_attrs:
        np.testing.assert_allclose(to_np(tfinal.pool.get(name)),
                                   to_np(jfinal.pool.get(name)), atol=ATOL, err_msg=name)
    for f in dataclasses.fields(tfinal.health):
        assert int(getattr(tfinal.health, f.name)) == int(getattr(jfinal.health, f.name))


def _observed(sim):
    return (sim.observe("position", lambda s: s.pool.position)
               .observe("alive", lambda s: s.pool.alive)
               .observe("kind", lambda s: s.pool.kind))


# ------------------------------------------------------------ tumor spheroid

# The start is looser than the chip's (a 20 µm lattice, not 12): in a packed
# spheroid every contact is stiff at dt = 1 h (k = 2), so an overlapping
# pair's separation error grows about 3× per step and the 1e-5 sum-order
# difference of the force kernels reaches 0.1 µm in 8 steps, in the
# reference's own impls as much as in the port.  With few contacts, births
# and deaths still fire and positions hold to 1e-4.
SPH_N, SPH_CAP, SPH_SPACE, SPH_STEPS, SPH_SEED, SPH_LATTICE = 300, 1024, 200.0, 8, 0, 20.0
SPH_WINDOW = 7       # 8 blocks of 128: every window covers the whole pool


@functools.lru_cache(maxsize=None)
def _spheroid_jax():
    import tumor_spheroid

    pos, diam, age = U.spheroid_start(SPH_N, SPH_SPACE, seed=SPH_SEED, lattice=SPH_LATTICE)
    sim = (
        JSimulation(space=(0.0, SPH_SPACE), cell_size=18.0, boundary="closed", dt=1.0,
                    capacity=SPH_CAP, max_per_cell=96, seed=SPH_SEED, sort_frequency=1)
        .add_agents(SPH_N, position=pos, diameter=diam, radial=0.0)
        .use(jc.brownian_motion(0.15), jc.growth(60.0, 18.0),
             jc.cell_division(0.02, trigger_diameter=17.0),
             jc.apoptosis(0.002, min_age=87.0))
        .mechanics(jc.ForceParams(), impl="fused", tile_order="morton",
                   morton_window=SPH_WINDOW)
        .op(tumor_spheroid.radial_census_op(SPH_SPACE / 2.0))
        .observe_kinds(frequency=3)
    )
    built = _observed(sim).build()
    ages = np.zeros(SPH_CAP, np.float32)
    ages[:SPH_N] = age
    state = dataclasses.replace(built.state,
                                pool=built.state.pool.replace(age=jnp.asarray(ages)))
    final, obs = built.run(SPH_STEPS, state=state)
    return state, final, {k: to_np(v) for k, v in obs.items()}


def test_spheroid_matches_jax():
    """Births, deaths, the morton window path and the census, 8 steps."""
    jstate, jfinal, jobs = _spheroid_jax()
    pos, diam, _ = U.spheroid_start(SPH_N, SPH_SPACE, seed=SPH_SEED, lattice=SPH_LATTICE)
    tsim = U.spheroid(pos, diam, space=SPH_SPACE, capacity=SPH_CAP, seed=SPH_SEED,
                      impl="fused", tile_order="morton", morton_window=SPH_WINDOW,
                      sort_frequency=1, rank_impl="cuda").observe_kinds(frequency=3)
    tbuilt, _, tfinal, tobs = _run_port(_observed(tsim), jstate, SPH_STEPS)
    assert tbuilt.config.tile_order == "morton" and tbuilt.config.morton_window == SPH_WINDOW
    _assert_same_run(jfinal, jobs, tfinal, tobs, float_attrs=("radial",))
    n1 = int(tobs["alive"][-1].sum())
    births = int((to_np(tfinal.pool.alive) & (to_np(tfinal.pool.age) <= SPH_STEPS)).sum())
    assert births > 0 and SPH_N + births - n1 > 0          # divisions and deaths both fired
    assert (to_np(tfinal.pool.get("radial"))[to_np(tfinal.pool.alive)] > 0).any()


# ----------------------------------------------------------------- SIR smoke

@functools.lru_cache(maxsize=None)
def _sir_jax():
    import epidemiology_sir as E

    counts, final = E.run_abm((3.24, 0.36, 6.2), 150, 6, 40.0, 10, return_state=True)
    return counts, final


def test_sir_smoke_matches_jax():
    """examples/epidemiology_sir.py --smoke: 150 agents, 10 steps, toroidal.
    The port draws the initial positions itself, from the same key."""
    jcounts, jfinal = _sir_jax()
    tfinal, tobs = U.sir((3.24, 0.36, 6.2), 150, 6, 40.0).run(10)
    np.testing.assert_array_equal(to_np(tobs["counts"]), jcounts)
    assert tobs["counts"].shape == (10, 3) and (to_np(tobs["counts"]).sum(1) == 150).all()
    for f in ("alive", "kind"):
        np.testing.assert_array_equal(to_np(getattr(tfinal.pool, f)),
                                      to_np(getattr(jfinal.pool, f)))
    np.testing.assert_allclose(to_np(tfinal.pool.position), to_np(jfinal.pool.position),
                               atol=ATOL)
    np.testing.assert_allclose(to_np(tfinal.pool.get("t_inf")),
                               to_np(jfinal.pool.get("t_inf")), atol=ATOL)
    assert float(tfinal.pool.get("t_inf").max()) > 0
    assert not np.array_equal(jcounts[0], jcounts[-1])      # the epidemic moved


# ------------------------------------------------------------- neurite smoke

NEU_N, NEU_STEPS = 4, 12


@functools.lru_cache(maxsize=None)
def _neurite_jax():
    import neurite_growth as G

    tsim = U.neurite(NEU_N)          # the same start, declared through the port
    g = tsim._groups[0]
    sim = (
        JSimulation(space=(0.0, 120.0), cell_size=4.0, boundary="closed", dt=0.5,
                    capacity=8192, max_per_cell=128, seed=0, diffusion_frequency=0)
        .add_agents(NEU_N, position=to_np(g.position), diameter=2.0,
                    kind=to_np(g.kind), direction=to_np(g.attrs["direction"]),
                    path_len=0.0)
        .add_substance("guide", diffusion=0.0, resolution=24,
                       concentration=to_np(tsim._grids["guide"].concentration))
        .use(G.neurite_extension("guide", speed=2.4, w_old=4.0, w_grad=1.5, w_rand=0.6,
                                 branch_prob=0.02, target_z=104.0))
        .mechanics(jc.ForceParams(static_tolerance=1e-3), active_capacity=2048)
        .op(G.path_length_op, name="path_length", phase="post")
        .observe_kinds(n_kinds=2)
    )
    built = _observed(sim).build()
    final, obs = built.run(NEU_STEPS)
    return built.state, final, {k: to_np(v) for k, v in obs.items()}


def test_neurite_smoke_matches_jax():
    """examples/neurite_growth.py --smoke: 4 neurons, 12 steps; trail
    deposits and branching through add_agents, §5.5 compaction."""
    jstate, jfinal, jobs = _neurite_jax()
    tsim = _observed(U.neurite(NEU_N).observe_kinds(n_kinds=2))
    _, _, tfinal, tobs = _run_port(tsim, jstate, NEU_STEPS)
    _assert_same_run(jfinal, jobs, tfinal, tobs, float_attrs=("path_len", "direction"))
    assert int(tobs["alive"][-1].sum()) > NEU_N
    assert float(tfinal.pool.get("path_len").max()) > 0
