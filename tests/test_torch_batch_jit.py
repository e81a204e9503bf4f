"""The batch engine's compiled run (``BatchedSimulation.run_jit``,
``jitted_batched_runner``, ``run_batch``, ``abm_serve``) on the CPU.

On CPU tensors the runner calls each captured step body as a plain function,
so the host count, the keys (live sessions, each session's firings, each
session's branches), the device flags and the rollback all run here.  The
port's ``run_jit`` is held to its own eager ``run`` bit for bit (every state
leaf, observable row and count, by bytes), and to the reference's compiled
batched run (``jitted_batched_runner`` / ``run_batch`` / ``serve``) at
tests/test_torch_batch.py's tolerances: alive flags, kinds, step counters,
kind counts, health and counts exact; positions ``atol=1e-4``; fields and
other float series ``rtol=1e-5``.

The flip cases make one session's branch predicate flip mid-run with a
custom op of tests/torch_jit_cases.py (its JAX twin in
tests/test_torch_run_jit.py) while the other session's holds: each run must
roll back at least once and leave the other session equal to its solo run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import test_torch_batch as TB
import test_torch_run_jit as RJ
import torch_jit_cases as J
import torch_usecases as U
from repro import Simulation as JSimulation
from repro_torch import Simulation as TSimulation
from repro_torch import core as tc
from repro_torch.core.batch import slot_state
from torch_force_cases import fused_call_counts
from torch_parity import to_np


def _assert_batch_bit_equal(a, b):
    """Two ``(bstate, obs, counts)`` results equal bit for bit."""
    (fa, oa, ca), (fb, ob, cb) = a, b
    J.assert_runs_bit_equal((fa, oa), (fb, ob))
    assert set(ca) == set(cb)
    for name in ca:
        assert ca[name].dtype == cb[name].dtype and ca[name].tolist() == cb[name].tolist()


def _both(eng, bstate, steps):
    """The port's eager ``run`` and ``run_jit`` from ``bstate``, bit for bit
    equal; returns the run_jit result and the runner's counts for it."""
    eager = eng.run(bstate, steps)
    before = dict(eng._jitted.stats)
    jit = eng.run_jit(bstate, steps)
    _assert_batch_bit_equal(eager, jit)
    return jit, {k: v - before[k] for k, v in eng._jitted.stats.items()}


def _assert_near_reference(t, j):
    """A port batch result within the tolerances of the reference's."""
    (tf, tobs, tcounts), (jf, jobs, jcounts) = t, j
    jobs = {k: to_np(v) for k, v in jobs.items()}
    pos = {k for k in tobs if k == "position"}
    TB._assert_matches_reference(tf.states, {k: v for k, v in tobs.items() if k not in pos},
                                 jf.states, {k: v for k, v in jobs.items() if k not in pos})
    for k in pos:
        np.testing.assert_allclose(to_np(tobs[k]), jobs[k], atol=1e-4, err_msg=k)
    assert set(tcounts) == set(jcounts)
    for k in tcounts:
        np.testing.assert_array_equal(to_np(tcounts[k]), to_np(jcounts[k]), err_msg=k)
    np.testing.assert_array_equal(to_np(tf.active), to_np(jf.active))


def _assert_slot_is_solo(built, bfinal, obs, counts, b, start, steps):
    """Slot ``b`` of a batch equals the solo run of its start."""
    solo, solo_obs = built.run(steps, state=start)
    got = slot_state(bfinal, b)
    assert J.leaf_bytes(solo) == J.leaf_bytes(got), f"slot {b}"
    for k, v in solo_obs.items():
        rows = obs[k][b][: int(counts[k][b])]
        assert v.numpy().tobytes() == rows.numpy().tobytes(), (b, k)


# ------------------------------------------------- sweeps, starts, budgets


def test_sweep_with_a_gated_observable_matches_run_and_the_reference():
    """tests/test_batch.py's model (sort every 4, ``mean_pos`` every 2,
    ``pop`` every step), 3 seeds with per-slot attrs, 7 steps: three keys,
    one graph each; ``run_batch`` takes the compiled run and starts warm."""
    seeds, params = [101, 202, 303], {"attr:infect": np.array([1, 2, 3], np.int32)}
    built = TB._model().build()
    eng = built.batched()
    (final, obs, counts), stats = _both(eng, eng.sweep_state(seeds=seeds, params=params), 7)
    assert obs["mean_pos"].shape == (3, 4, 3) and counts["mean_pos"].tolist() == [4] * 3
    assert counts["pop"].tolist() == [7] * 3
    assert stats["graphs"] == 3 and stats["replays"] == 4 and stats["rollbacks"] == 0
    tfinals, tobs = built.run_batch(7, params, seeds=seeds)
    assert eng._jitted.stats["warm_starts"] == 1 and eng._jitted.stats["graphs"] == 3
    assert J.leaf_bytes(tfinals) == J.leaf_bytes(final.states)
    for k in obs:
        assert tobs[k].numpy().tobytes() == obs[k].numpy().tobytes(), k
    jfinals, jobs = TB._jax_run_batch(TB._model(pkg=JSimulation, lib=jc, xp=jnp), 7, seeds,
                                      params)
    TB._assert_matches_reference(tfinals, tobs, jfinals, jobs)


def _jax_model(**kw):
    return TB._model(pkg=JSimulation, lib=jc, xp=jnp, **kw).build()


def test_misaligned_starts_record_each_sessions_own_rows():
    """A fresh session beside one 4 steps ahead, sort and ``mean_pos``
    every 3: each fires by its own counter, writes its own rows, and equals
    its solo run; the reference's compiled batch gives the same."""
    built = TB._model(sort_frequency=3, obs_freq=3).build()
    eng = built.batched()
    fresh = eng.session_state(seed=5)
    ahead, _ = built.run(4, state=eng.session_state(seed=6))
    (final, obs, counts), stats = _both(eng, eng.stack([fresh, ahead]), 6)
    assert counts["mean_pos"].tolist() == [2, 2] and stats["rollbacks"] == 0
    for b, start in enumerate((fresh, ahead)):
        _assert_slot_is_solo(built, final, obs, counts, b, start, 6)
    jbuilt = _jax_model(sort_frequency=3, obs_freq=3)
    jeng = jbuilt.batched()
    jahead, _ = jbuilt.run(4, state=jeng.session_state(seed=6))
    _assert_near_reference((final, obs, counts),
                           jeng.run_jit(jeng.stack([jeng.session_state(seed=5), jahead]), 6))


def test_a_budget_that_ends_mid_run_and_an_inactive_slot():
    """Slot 0 budgeted to 5 of 9 steps, slot 1 empty, slot 2 unbounded: the
    live tuple changes mid-run (a new key), slot 1 stays bit-frozen; a
    batch whose budgets all end stops there."""
    built = TB._model().build()
    eng = built.batched()
    bstate = eng.inject(eng.empty_state(3), 0, eng.session_state(seed=12), budget=5)
    bstate = eng.inject(bstate, 2, eng.session_state(seed=13))
    (final, obs, counts), stats = _both(eng, bstate, 9)
    assert final.states.step.tolist() == [5, 0, 9]
    assert counts["pop"].tolist() == [5, 0, 9] and counts["mean_pos"].tolist() == [3, 0, 5]
    assert J.leaf_bytes(slot_state(final, 1)) == J.leaf_bytes(slot_state(bstate, 1))
    _assert_slot_is_solo(built, final, obs, counts, 0, eng.session_state(seed=12), 5)
    short = eng.stack([eng.session_state(seed=1), eng.session_state(seed=2)], budgets=[2, 3])
    (_, _, short_counts), short_stats = _both(eng, short, 9)
    assert short_counts["pop"].tolist() == [2, 3]
    assert short_stats["replays"] + short_stats["eager_steps"] == 3
    jbuilt = _jax_model()
    jeng = jbuilt.batched()
    jb = jeng.inject(jeng.empty_state(3), 0, jeng.session_state(seed=12), budget=5)
    jb = jeng.inject(jb, 2, jeng.session_state(seed=13))
    _assert_near_reference((final, obs, counts), jeng.run_jit(jb, 9))


# ----------------------------------------------------- births and deaths


def _spheroid(pkg, lib, pos, diam, **kw):
    return (
        pkg(space=(0.0, 200.0), cell_size=18.0, boundary="closed", dt=1.0, capacity=160,
            max_per_cell=32, seed=0, sort_frequency=2, **kw)
        .add_agents(60, position=pos, diameter=diam)
        .use(lib.brownian_motion(0.15), lib.growth(60.0, 18.0),
             lib.cell_division(0.3, trigger_diameter=15.0), lib.apoptosis(0.05))
        .observe_kinds(n_kinds=1, frequency=2)
    )


def test_spheroid_with_births_deaths_and_the_dense_kernel():
    """Per-slot draws, births into each slot's free rows and deaths, the
    forces through the dense ``pairwise_force`` (its plain version here):
    run_jit equals run; the reference's dense forces agree within
    tolerance."""
    pos, diam, _ = U.spheroid_start(60, 200.0, lattice=20.0)
    built = _spheroid(TSimulation, tc, pos, diam, device="cpu").mechanics(
        tc.ForceParams(), impl="cuda").build()
    (final, obs, counts), stats = _both(built.batched(),
                                        built.batched().sweep_state(seeds=[3, 4]), 4)
    alive = to_np(final.states.pool.alive)
    assert (alive[:, 60:].sum(1) > 0).all() and (~alive[:, :60]).sum() > 0
    assert stats["rollbacks"] == 0 and stats["replays"] >= 1
    jbuilt = _spheroid(JSimulation, jc, pos, diam).mechanics(jc.ForceParams()).build()
    jeng = jbuilt.batched()
    _assert_near_reference((final, obs, counts),
                           jeng.run_jit(jeng.sweep_state(seeds=[3, 4]), 4))


# ----------------------------------------- one session's predicate flips

_FLIPS = {
    # name: (model, JAX op, port op, port mechanics, predicate)
    "crowd": (RJ._sparse, RJ._jax_crowd_op(5, 3, 20.0), J.crowd_op(5, 3, 20.0),
              dict(impl="fused"), "overflowed"),
    "kick": (RJ._octets, RJ._jax_kick_op(3, RJ._P, RJ._Q), J.kick_op(3, RJ._P, RJ._Q),
             dict(impl="fused", tile_order="morton", morton_block=4), "window"),
    "nudge": (RJ._resting, RJ._jax_nudge_op(12, 3, 0.01), J.nudge_op(12, 3, 0.01),
              dict(impl="fused", active_capacity=8), "crowded"),
}
FLIP_STEPS = 6


@pytest.mark.parametrize("flip", sorted(_FLIPS))
def test_one_sessions_predicate_flips_mid_run(monkeypatch, flip):
    """Session 0 starts at step 0 and its predicate flips after step 3;
    session 1 starts at step 100 with the op applied once already, so its
    predicate holds from its first step.  The sessions take different
    branches (the kick case is a Morton batch with one session on the window
    kernel and one on the linear kernel, each launched once a step), the
    run rolls back at least once, and each session equals its solo run.
    The reference's compiled batch runs its dense force pass (impl
    "reference"), whose pairs every fused branch reproduces: its
    interpret-mode Morton pass, vmapped, takes ~25 s to compile here."""
    declare, jop, top, mechanics, pred = _FLIPS[flip]
    if flip == "kick":
        mechanics = dict(mechanics, morton_window=RJ._covering_window(4) + 1)

    def build(sim, op):
        sim.op(op, name="flip", phase="agent")
        return sim.observe("position", lambda s: s.pool.position).build()

    built = build(declare(TSimulation, tc, device="cpu").mechanics(tc.ForceParams(),
                                                                  **mechanics), top)
    eng = built.batched()
    ahead = top(None, dataclasses.replace(built.state, step=torch.tensor(100, dtype=torch.int32)))
    starts = [built.state, ahead]
    calls = fused_call_counts(monkeypatch)
    (final, obs, counts), stats = _both(eng, eng.stack(starts), FLIP_STEPS)
    assert stats["rollbacks"] >= 1 and stats["replays"] >= 1
    taken = {dict(k[1])[pred] for k in eng._jitted._graphs}
    assert (False, True) in taken or (True, False) in taken, taken
    if flip == "kick":
        assert (True, False) in taken and calls["window"] and calls["linear"]
    monkeypatch.undo()
    for b, start in enumerate(starts):
        _assert_slot_is_solo(built, final, obs, counts, b, start, FLIP_STEPS)
    dense = {k: v for k, v in mechanics.items() if k == "active_capacity"}
    jbuilt = build(declare(JSimulation, jc).mechanics(jc.ForceParams(), **dense), jop)
    jeng = jbuilt.batched()
    jahead = jop(None, dataclasses.replace(jbuilt.state, step=jnp.asarray(100, jnp.int32)))
    _assert_near_reference((final, obs, counts),
                           jeng.run_jit(jeng.stack([jbuilt.state, jahead]), FLIP_STEPS))


def test_count_kinds_without_n_kinds_raises_under_the_batch_run_jit():
    """The kind count sizes its output: neither package derives it inside a
    compiled batched run; the eager run derives it."""
    built = TB._model().observe("kinds", tc.count_kinds, frequency=2).build()
    eng = built.batched()
    bstate = eng.sweep_state(seeds=[1, 2])
    _, obs, _ = eng.run(bstate, 3)
    assert obs["kinds"].shape == (2, 2, 1)
    with pytest.raises(ValueError, match="n_kinds"):
        eng.run_jit(bstate, 3)
    jeng = TB._model(pkg=JSimulation, lib=jc, xp=jnp).observe(
        "kinds", jc.count_kinds, frequency=2).build().batched()
    with pytest.raises(ValueError, match="n_kinds"):
        jeng.run_jit(jeng.sweep_state(seeds=[1, 2]), 3)


# ------------------------------------------------------ serving and reuse


def test_serve_chunks_start_with_a_replay(monkeypatch):
    """abm_serve's SIR demo, 4 sessions through 4 slots in chunks of 8
    (budgets 24, one of 21): the second and third chunks start with a
    replay; every series equals the eager serve's bit for bit, its solo
    run's, and the reference's serve's kind counts."""
    from repro.launch import abm_serve as jserve
    from repro_torch.launch import abm_serve as tserve

    def requests(mod):
        return [mod.SessionRequest(name=f"u{i}", n_steps=21 if i == 2 else 24, seed=100 + i)
                for i in range(4)]

    built = tserve._demo_model(True, "cpu")
    eng = built.batched()
    got = {r.name: r for r in tserve.serve(built, requests(tserve), slots=4, chunk=8,
                                           log=None)}
    stats = eng._jitted.stats
    assert stats["runs"] == 3 and stats["warm_starts"] == 2 and stats["rollbacks"] == 0
    monkeypatch.setattr(eng, "run_jit", eng.run)
    eager = {r.name: r for r in tserve.serve(built, requests(tserve), slots=4, chunk=8,
                                             log=None)}
    jgot = {r.name: r for r in jserve.serve(jserve._demo_model(True), requests(jserve),
                                            slots=4, chunk=8, log=None)}
    for req in requests(tserve):
        r = got[req.name]
        assert r.status == "done" and r.steps == req.n_steps
        assert tserve._series_sha(r.obs) == tserve._series_sha(eager[req.name].obs)
        assert J.leaf_bytes(r.final) == J.leaf_bytes(eager[req.name].final)
        _, solo = built.run(req.n_steps, state=eng.session_state(seed=req.seed))
        assert tserve._series_sha(r.obs) == tserve._series_sha(solo)
        np.testing.assert_array_equal(r.obs["kind_counts"],
                                      np.asarray(jgot[req.name].obs["kind_counts"]))


def test_solo_and_batch_runners_at_two_widths_keep_their_graphs():
    """One model's solo runner and its batch runner at widths 2 and 3: a
    repeated call captures nothing and starts warm; each equals its eager
    run, and the width-3 sweep the reference's."""
    built = TB._model().build()
    eng = built.batched()
    narrow, wide = eng.sweep_state(seeds=[1, 2]), eng.sweep_state(seeds=[3, 4, 5])

    def runs():
        return (built.run_jit(6), eng.run_jit(narrow, 6), eng.run_jit(wide, 6))

    first = runs()
    graphs = (built._jitted.stats["graphs"], eng._jitted.stats["graphs"])
    warm = (built._jitted.stats["warm_starts"], eng._jitted.stats["warm_starts"])
    assert len(eng._jitted._layouts) == 2 and warm == (0, 0)
    again = runs()
    assert (built._jitted.stats["graphs"], eng._jitted.stats["graphs"]) == graphs
    assert (built._jitted.stats["warm_starts"], eng._jitted.stats["warm_starts"]) == (1, 2)
    J.assert_runs_bit_equal(first[0], built.run(6))
    J.assert_runs_bit_equal(again[0], first[0])
    for i, bstate in ((1, narrow), (2, wide)):
        _assert_batch_bit_equal(first[i], eng.run(bstate, 6))
        _assert_batch_bit_equal(again[i], first[i])
    jeng = _jax_model().batched()
    _assert_near_reference(first[2], jeng.run_jit(jeng.sweep_state(seeds=[3, 4, 5]), 6))
