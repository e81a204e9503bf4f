"""The port's batch engine (``repro_torch.core.batch``) on the CPU.

The contract of tests/test_batch.py, ported: a slot of a batched run is
bit-identical to a solo run of that session on the port, while the slot
lifecycle (inactive slots, budgets, admit/evict between chunks) only ever
freezes or thaws whole slots.  Then the port's ``run_batch`` against the
reference's on tests/test_batch.py's model and on the soma and spheroid
models at a small size (reference impls on both sides), and the per-slot
branches (the fused path's overflow fallback, §5.5 compaction) taken by
some slots and not others.

Tolerances against the reference: alive flags, kinds, step counters, kind
counts exact; positions ``atol=1e-4``; fields and custom series
``rtol=1e-5`` (as tests/test_torch_engine.py).  Against the port's own
solo runs: every leaf and every series bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
import torch_faults as TF
import torch_usecases as U
from repro import Simulation as JSimulation
from repro_torch import Simulation
from repro_torch.checkpoint.checkpoint import _leaves_with_paths
from repro_torch.core import ForceParams, behaviors
from repro_torch.core.batch import slot_state
from repro_torch.core.slots import slot_of
from torch_force_cases import fused_call_counts
from torch_parity import to_np


def _model(n=24, seed=3, infect=0, sort_frequency=4, obs_freq=2, pkg=Simulation, lib=behaviors,
           xp=torch):
    rng = np.random.default_rng(11)
    kw = {"device": "cpu"} if pkg is Simulation else {}
    mean = (lambda s: s.pool.position.mean(dim=0)) if xp is torch else (
        lambda s: s.pool.position.mean(axis=0))
    pop = (lambda s: s.pool.alive.sum(dtype=torch.int32)) if xp is torch else (
        lambda s: s.pool.alive.sum().astype(jnp.int32))
    return (
        pkg(space=24.0, cell_size=4.0, boundary="toroidal", dt=1.0, capacity=n,
            max_per_cell=8, sort_frequency=sort_frequency, seed=seed, **kw)
        .add_agents(position=rng.uniform(0, 24, (n, 3)), diameter=1.0,
                    kind=0, infect=np.full(n, infect, np.int32))
        .use(lib.random_movement(1.0))
        .observe("mean_pos", mean, frequency=obs_freq)
        .observe("pop", pop)
    )


def _differing(a, b):
    """Leaves of two states that are not the same bits (dtype, shape, bytes)."""
    la, lb = dict(_leaves_with_paths(a)), dict(_leaves_with_paths(b))
    assert list(la) == list(lb)
    return [k for k in la if la[k].dtype != lb[k].dtype or la[k].shape != lb[k].shape
            or la[k].numpy().tobytes() != lb[k].numpy().tobytes()]


def _assert_states_equal(a, b, msg=""):
    bad = _differing(a, b)
    assert not bad, f"{msg}: leaves {bad} diverged"


def _assert_series_equal(solo, batched, msg=""):
    assert set(solo) == set(batched), msg
    for k in solo:
        assert solo[k].numpy().tobytes() == batched[k].numpy().tobytes(), (msg, k)


# ------------------------------------------------------- slot == solo


def test_sweep_slot_bitexact_vs_solo_including_observables():
    built = _model().build()
    seeds = [101, 202, 303]
    finals, obs = built.run_batch(7, seeds=seeds)
    # freq-2 observable over 7 steps fires at 0,2,4,6 -> 4 rows
    assert obs["mean_pos"].shape == (3, 4, 3)
    assert obs["pop"].shape == (3, 7)
    eng = built.batched()
    for b, seed in enumerate(seeds):
        sf, so = built.run(7, state=eng.session_state(seed=seed))
        _assert_states_equal(sf, slot_of(finals, b), f"slot {b}")
        _assert_series_equal(so, {k: v[b] for k, v in obs.items()}, f"slot {b}")


def test_attr_override_bitexact_vs_declared_model():
    # A per-slot attr override must equal a model that *declared* the value
    # in add_agents — same zero-padded pool construction, same key.
    finals, _ = _model(seed=0).build().run_batch(
        5, {"attr:infect": np.array([2, 9], np.int32)}, seeds=[40, 41])
    for b, (seed, infect) in enumerate([(40, 2), (41, 9)]):
        sf, _ = _model(seed=seed, infect=infect).build().run(5)
        _assert_states_equal(sf, slot_of(finals, b), f"slot {b} (declared infect={infect})")


def test_misaligned_chunk_starts_keep_freq_k_observables_exact():
    # Slots whose step counters disagree (one mid-run, one fresh) must each
    # fire frequency-k observables, and the frequency-3 sort, by their OWN
    # counter.
    built = _model(sort_frequency=3, obs_freq=3).build()
    eng = built.batched()
    fresh = eng.session_state(seed=5)
    ahead, _ = built.run(4, state=eng.session_state(seed=6))  # step=4
    bstate = eng.stack([fresh, ahead])
    bstate, obs, counts = eng.run_jit(bstate, 6)
    # fresh fires at 0,3 within [0,6) -> 2 rows; ahead at 6,9 within [4,10)
    assert counts["mean_pos"].tolist() == [2, 2]
    solo_fresh, obs_fresh = built.run(6, state=fresh)
    solo_ahead, obs_ahead = built.run(6, state=ahead)
    _assert_states_equal(solo_fresh, slot_state(bstate, 0), "fresh")
    _assert_states_equal(solo_ahead, slot_state(bstate, 1), "ahead")
    for b, solo in ((0, obs_fresh), (1, obs_ahead)):
        got = obs["mean_pos"][b][: int(counts["mean_pos"][b])]
        assert torch.equal(solo["mean_pos"], got), b


# --------------------------------------------------- lifecycle semantics


def test_inactive_slots_are_bit_frozen():
    built = _model().build()
    eng = built.batched()
    bstate = eng.empty_state(3)
    bstate = eng.inject(bstate, 1, eng.session_state(seed=8))
    before = [slot_state(bstate, b) for b in (0, 2)]
    bstate, _, _ = eng.run_jit(bstate, 5)
    assert int(bstate.states.step[1]) == 5
    for b, prior in zip((0, 2), before):
        _assert_states_equal(prior, slot_state(bstate, b), f"inactive slot {b}")


def test_per_slot_rng_streams():
    built = _model().build()
    finals, _ = built.run_batch(4, seeds=[5, 5, 9], batch=3)
    same = finals.pool.position
    assert torch.equal(same[0], same[1])        # same seed -> same run
    assert not torch.equal(same[0], same[2])    # different seed -> differs
    # default streams (no seeds): fold_in(template_rng, slot) are distinct
    finals2, _ = built.run_batch(4, batch=2)
    assert not torch.equal(finals2.pool.position[0], finals2.pool.position[1])


def test_budget_freezes_slot_mid_scan_and_evict_resume_is_deterministic():
    built = _model().build()
    eng = built.batched()
    s0 = eng.session_state(seed=12)
    noise = eng.session_state(seed=77)
    # 6 budgeted steps inside a 9-step chunk, alongside other traffic ...
    bstate = eng.stack([s0, noise], budgets=[6, 9])
    bstate, _, _ = eng.run_jit(bstate, 9)
    assert int(bstate.states.step[0]) == 6
    mid, bstate = eng.evict(bstate, 0)
    # ... then resumed in a DIFFERENT slot of a different batch: the
    # composite must equal the uninterrupted solo run.
    b2 = eng.empty_state(3)
    b2 = eng.inject(b2, 2, mid, budget=4)
    b2, _, _ = eng.run_jit(b2, 7)
    assert int(b2.states.step[2]) == 10
    solo, _ = built.run(10, state=s0)
    _assert_states_equal(solo, slot_state(b2, 2), "evict/inject resume")


# ------------------------------------------------ validation + cache


def test_inject_rejects_capacity_mismatch_naming_slot_and_capacities():
    eng = _model(n=24).build().batched()
    foreign = _model(n=32).build().state
    with pytest.raises(ValueError, match=r"slot 1.*capacity 32.*capacity 24"):
        eng.inject(eng.empty_state(2), 1, foreign)
    with pytest.raises(ValueError, match=r"slot 0.*capacity 32.*capacity 24"):
        eng.stack([foreign])


def test_inject_rejects_schema_mismatch_and_occupied_slot():
    built = _model().build()
    eng = built.batched()
    other = dataclasses.replace(
        built.state,
        pool=built.state.pool.replace(position=built.state.pool.position.to(torch.float16)),
    )
    with pytest.raises(ValueError, match=r"slot 0.*position"):
        eng.inject(eng.empty_state(1), 0, other)
    bstate = eng.inject(eng.empty_state(1), 0, built.state)
    with pytest.raises(ValueError, match="occupied"):
        eng.inject(bstate, 0, built.state)


def test_run_batch_rejects_bad_override_keys_and_widths():
    built = _model().build()
    with pytest.raises(ValueError, match="no attr 'nope'"):
        built.run_batch(2, {"attr:nope": np.zeros(2)})
    with pytest.raises(ValueError, match="unknown override target"):
        built.run_batch(2, {"substanceX:q": np.zeros(2)})
    with pytest.raises(ValueError, match="2 slots.*3 wide"):
        built.run_batch(2, {"attr:infect": np.zeros(2, np.int32)}, seeds=[1, 2, 3])
    with pytest.raises(ValueError, match="sweep width"):
        built.run_batch(2)


def test_solo_and_batched_runners_coexist_without_retracing():
    # ``batched()`` is built once and cached (its compiled runner with it),
    # and solo runs before and after batched ones are unaffected by them.
    calls = {"n": 0}

    def counting(ctx, state):
        calls["n"] += 1
        return state

    sim = _model()
    sim.op(counting, name="trace_counter", phase="post")
    built = sim.build()

    first, first_obs = built.run(3)
    assert calls["n"] == 3
    eng = built.batched()
    assert built.batched() is eng
    built.run_batch(3, seeds=[1, 2])
    assert calls["n"] == 3 + 2 * 3                # a custom op runs once a slot
    built.run_batch(3, seeds=[3, 4])
    assert built.batched() is eng
    again, again_obs = built.run(3)
    _assert_states_equal(first, again, "solo run after batched runs")
    _assert_series_equal(first_obs, again_obs, "solo series")
    assert set(built._runner_cache) == {("batch",)}


# ------------------------------------------- per-slot branches + kernels


def _sweep_equals_solo(built, n_steps, seeds, params=None):
    finals, obs = built.run_batch(n_steps, params, seeds=seeds)
    eng = built.batched()
    for b, seed in enumerate(seeds):
        p = None if params is None else {k: np.asarray(v)[b] for k, v in params.items()}
        sf, so = built.run(n_steps, state=eng.session_state(seed=seed, params=p))
        _assert_states_equal(sf, slot_of(finals, b), f"slot {b}")
        _assert_series_equal(so, {k: v[b] for k, v in obs.items()}, f"slot {b}")
    return finals, obs


def test_soma_with_the_kernels_plain_versions_sweeps_bitexact():
    """The slice's impls (fused, rank and diffusion "cuda": their plain
    versions on the CPU) with a per-slot substance override."""
    sim = U.soma(60, 60.0).observe_kinds(frequency=3).observe(
        "exposure", lambda s: s.pool.get("exposure").sum())
    sim.rank_impl = "cuda"
    built = sim.mechanics(ForceParams(), impl="fused", diffusion_impl="cuda").build()
    assert built.config.spec.rank_impl == "cuda"
    finals, obs = _sweep_equals_solo(
        built, 6, [1, 2, 3], {"substance:substance_0": np.array([0.0, 1.0, 2.5], np.float32)})
    assert obs["kind_counts"].shape == (3, 2, 2) and obs["exposure"].shape == (3, 6)
    assert float(finals.grids["substance_0"].concentration[2].max()) > 2.0


def test_spheroid_sweep_with_births_deaths_and_dense_kernel_is_bitexact():
    """Per-slot threefry draws, births into each slot's own free rows,
    deaths, the sort every step, and the dense pairwise path."""
    pos, diam, _ = U.spheroid_start(150, 200.0, lattice=20.0)
    for impl, steps in (("fused", 6), ("cuda", 3)):
        built = U.spheroid(pos, diam, space=200.0, capacity=512, sort_frequency=1,
                           rank_impl="cuda", impl=impl).observe_kinds(frequency=2).build()
        finals, _ = _sweep_equals_solo(built, steps, [5, 6, 7])
        if impl == "fused":
            born = finals.pool.alive.sum(1) - 150 + (~finals.pool.alive[:, :150]).sum(1)
            assert bool((born > 0).all())            # every slot divided
            assert not torch.equal(finals.pool.alive[0], finals.pool.alive[1])


def test_overflow_fallback_taken_by_one_slot_only():
    """The fused path's dense fallback in the slot whose cell overflowed,
    the kernel in the other: each equals its solo run."""
    built = TF.overfull_cell_sim().build()
    eng = built.batched()
    crowded = eng.session_state(seed=1)
    pos = crowded.pool.position.clone()
    pos[30:42] = torch.linspace(1.0, 19.0, 12)[:, None].expand(12, 3)
    spread = dataclasses.replace(crowded, pool=crowded.pool.replace(position=pos))
    bstate, _, _ = eng.run(eng.stack([crowded, spread]), 3)
    for b, start in enumerate((crowded, spread)):
        solo, _ = built.run(3, state=start)
        _assert_states_equal(solo, slot_state(bstate, b), f"slot {b}")
    assert bstate.states.health.cell_overflow_steps.tolist() == [3, 0]


def test_compaction_fallback_taken_by_one_slot_only():
    """§5.5 work compaction in one slot, the full evaluation in the slot
    whose active set outgrew ``active_capacity``."""
    sim = U.neurite(4)
    sim.capacity = 256
    sim._force_opts["active_capacity"] = 12
    built = sim.build()
    eng = built.batched()
    fresh = eng.session_state(seed=0)
    grown, _ = built.run(5, state=eng.session_state(seed=1))
    bstate, _, _ = eng.run(eng.stack([fresh, grown]), 3)
    for b, start in enumerate((fresh, grown)):
        solo, _ = built.run(3, state=start)
        _assert_states_equal(solo, slot_state(bstate, b), f"slot {b}")
    active = (grown.pool.alive & ~grown.pool.static).sum()
    assert int(active) > 12 >= int((fresh.pool.alive & ~fresh.pool.static).sum())


def test_morton_window_in_a_batch_runs_and_each_slot_equals_solo(monkeypatch):
    """The calls that raised while the window kernel had no slot axis
    (``batched()``, ``run_batch``) run: each slot equals its solo run, and
    the window dispatcher is called once a step for all the slots."""
    pos, diam, _ = U.spheroid_start(40, 200.0, lattice=20.0)
    built = U.spheroid(pos, diam, space=200.0, capacity=128, tile_order="morton",
                       morton_window=4, sort_frequency=1).build()
    calls = fused_call_counts(monkeypatch)
    finals, _ = built.run_batch(2, batch=2)
    assert calls == {"window": 2, "linear": 0}
    eng = built.batched()
    bstate, _, _ = eng.run(eng.stack([eng.session_state(seed=1), eng.session_state(seed=2)]), 2)
    for b, seed in enumerate((1, 2)):
        solo, _ = built.run(2, state=eng.session_state(seed=seed))
        _assert_states_equal(solo, slot_state(bstate, b), f"slot {b}")
    rng = built.state.rng
    for b in range(2):
        key = tc.prng.fold_in(rng, b)
        solo, _ = built.run(2, state=dataclasses.replace(built.state, rng=key))
        _assert_states_equal(solo, slot_of(finals, b), f"run_batch slot {b}")


# --------------------------------------------- against the reference


def _jax_run_batch(jsim, n_steps, seeds, params=None):
    finals, obs = jsim.build().run_batch(n_steps, params, seeds=seeds)
    return finals, {k: to_np(v) for k, v in obs.items()}


def _assert_matches_reference(tfinals, tobs, jfinals, jobs, float_attrs=()):
    assert set(tobs) == set(jobs)
    for k in jobs:
        got = to_np(tobs[k])
        if np.issubdtype(got.dtype, np.floating):
            np.testing.assert_allclose(got, jobs[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, jobs[k], err_msg=k)
    for f in ("alive", "kind", "overflow"):
        np.testing.assert_array_equal(to_np(getattr(tfinals.pool, f)),
                                      to_np(getattr(jfinals.pool, f)), err_msg=f)
    np.testing.assert_array_equal(to_np(tfinals.step), to_np(jfinals.step))
    np.testing.assert_allclose(to_np(tfinals.pool.position), to_np(jfinals.pool.position),
                               atol=1e-4)
    for name in float_attrs:
        np.testing.assert_allclose(to_np(tfinals.pool.get(name)),
                                   to_np(jfinals.pool.get(name)), rtol=1e-5, atol=1e-6)
    for name, g in jfinals.grids.items():
        np.testing.assert_allclose(to_np(tfinals.grids[name].concentration),
                                   to_np(g.concentration), rtol=1e-5, atol=1e-6)
    for f in dataclasses.fields(tfinals.health):
        np.testing.assert_array_equal(to_np(getattr(tfinals.health, f.name)),
                                      to_np(getattr(jfinals.health, f.name)))


def test_run_batch_matches_the_reference_on_the_contract_model():
    seeds = [101, 202, 303]
    jfinals, jobs = _jax_run_batch(_model(pkg=JSimulation, lib=jc, xp=jnp), 7, seeds,
                                   {"attr:infect": np.array([1, 2, 3], np.int32)})
    tfinals, tobs = _model().build().run_batch(7, {"attr:infect": np.array([1, 2, 3],
                                                                           np.int32)},
                                               seeds=seeds)
    _assert_matches_reference(tfinals, tobs, jfinals, jobs)
    np.testing.assert_array_equal(to_np(tfinals.rng),
                                  to_np(jax.random.key_data(jfinals.rng)
                                        if jax.dtypes.issubdtype(jfinals.rng.dtype,
                                                                 jax.dtypes.prng_key)
                                        else jfinals.rng))


def _soma(pkg, lib, xp, **kw):
    def exposure_op(ctx, state):
        pool = state.pool
        c0 = lib.concentration_at(state.grids["substance_0"], pool.position)
        own = xp.where(pool.kind == 0, c0, 0.5 * c0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + own))

    rng = np.random.default_rng(0)
    pos = rng.uniform(10, 50, (40, 3)).astype(np.float32)
    kind = (rng.random(40) < 0.5).astype(np.int32)
    i, j, k = np.meshgrid(*[np.arange(8, dtype=np.float32)] * 3, indexing="ij")
    return (
        pkg(space=(0.0, 60.0), cell_size=10.0, boundary="closed", dt=1.0,
            max_per_cell=16, seed=0, **kw)
        .add_agents(40, position=pos, diameter=5.0, kind=kind, exposure=0.0)
        .add_substance("substance_0", diffusion=4.0, decay=0.002, resolution=8,
                       concentration=(2.0 + 0.6 * i + 0.4 * j + 0.2 * k))
        .use(lib.secretion("substance_0", 1.0, kind=0),
             lib.chemotaxis("substance_0", 0.75, kind=0))
        .mechanics(lib.ForceParams())
        .op(exposure_op, name="exposure", phase="post")
        .observe_kinds(frequency=2)
    )


def test_run_batch_matches_the_reference_on_soma():
    params = {"substance:substance_0": np.array([1.0, 3.0], np.float32)}
    jfinals, jobs = _jax_run_batch(_soma(JSimulation, jc, jnp), 4, [7, 8], params)
    tfinals, tobs = _soma(Simulation, tc, torch,
                          device="cpu").build().run_batch(4, params, seeds=[7, 8])
    _assert_matches_reference(tfinals, tobs, jfinals, jobs, float_attrs=("exposure",))


MORTON_BLOCK = 32


def _spheroid_morton(pkg, lib, pos, diam, window, **kw):
    """The spheroid at the Table 4.2 rates, sorted every step, forces by the
    Morton window (blocks of 32 rows, 12 of them)."""
    return (
        pkg(space=(0.0, 200.0), cell_size=18.0, boundary="closed", dt=1.0,
            capacity=384, max_per_cell=16, seed=0, sort_frequency=1, **kw)
        .add_agents(len(pos), position=pos, diameter=diam)
        .use(lib.brownian_motion(0.15), lib.growth(60.0, 18.0),
             lib.cell_division(0.02, trigger_diameter=17.0),
             lib.apoptosis(0.002, min_age=87.0))
        .mechanics(lib.ForceParams(), impl="fused", tile_order="morton",
                   morton_block=MORTON_BLOCK, morton_window=window)
        .observe_kinds(n_kinds=1)
    )


def test_morton_run_batch_matches_the_reference_on_the_spheroid(monkeypatch):
    """3 slots of 300 cells (the parity tests' 20 µm lattice), 3 steps, the
    window at the covering half-window of the sorted start + 25%: the port's
    run_batch against the reference's (vmapped, Pallas in interpret mode).
    Integers exact, positions within 1e-4; each slot bit-identical to the
    port's solo run."""
    from repro_torch.core import forces as t_forces
    from repro_torch.core import grid as t_grid

    pos, diam, _ = U.spheroid_start(300, 200.0, lattice=20.0)
    template = _spheroid_morton(Simulation, tc, pos, diam, 1, device="cpu").build()
    spec = template.config.spec
    pool = t_grid.sort_agents(spec, template.state.pool)
    cover = t_forces.covering_half_window(
        spec, t_grid.build_index(spec, pool, assume_sorted=True), MORTON_BLOCK)
    window = cover + -(-cover // 4)
    assert 0 < cover < window < 384 // MORTON_BLOCK
    seeds = [3, 4, 5]
    jfinals, jobs = _jax_run_batch(_spheroid_morton(JSimulation, jc, pos, diam, window), 3,
                                   seeds)
    built = _spheroid_morton(Simulation, tc, pos, diam, window, device="cpu").build()
    calls = fused_call_counts(monkeypatch)
    tfinals, tobs = built.run_batch(3, seeds=seeds)
    assert calls == {"window": 3, "linear": 0}
    _assert_matches_reference(tfinals, tobs, jfinals, jobs)
    alive = to_np(tfinals.pool.alive)
    assert (alive[:, 300:].sum(1) > 0).all()                 # births in every slot
    eng = built.batched()
    for b, seed in enumerate(seeds):
        solo, _ = built.run(3, state=eng.session_state(seed=seed))
        _assert_states_equal(solo, slot_of(tfinals, b), f"slot {b}")


def test_run_batch_matches_the_reference_on_the_spheroid():
    pos, diam, _ = U.spheroid_start(60, 200.0, lattice=20.0)

    def declare(pkg, lib, **kw):
        return (
            pkg(space=(0.0, 200.0), cell_size=18.0, boundary="closed", dt=1.0,
                capacity=160, max_per_cell=32, seed=0, sort_frequency=2, **kw)
            .add_agents(60, position=pos, diameter=diam)
            .use(lib.brownian_motion(0.15), lib.growth(60.0, 18.0),
                 lib.cell_division(0.3, trigger_diameter=15.0), lib.apoptosis(0.05))
            .mechanics(lib.ForceParams())
            .observe_kinds(n_kinds=1)
        )

    jfinals, jobs = _jax_run_batch(declare(JSimulation, jc), 4, [3, 4])
    tfinals, tobs = declare(Simulation, tc,
                            device="cpu").build().run_batch(4, seeds=[3, 4])
    _assert_matches_reference(tfinals, tobs, jfinals, jobs)
    alive = to_np(tfinals.pool.alive)
    assert (alive[:, 60:].sum(1) > 0).all() and (~alive[:, :60]).sum() > 0
