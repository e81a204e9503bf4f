"""The port's continuous-batching session server (``launch/abm_serve``).

The contract of tests/test_serve.py, ported: more sessions than slots flow
through a fixed pool in chunks, each retiring with a series bit-identical
to its solo run on the port; a NaN-ing session is evicted on its per-slot
HealthReport without touching its neighbours; a retired session's final
state re-enters as a resume.  Then the command line, on the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_faults as TF
from repro_torch import Simulation
from repro_torch.checkpoint.checkpoint import _leaves_with_paths
from repro_torch.core import behaviors
from repro_torch.launch.abm_serve import SessionRequest, _series_sha, serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _model(n=16, bomb=False):
    rng = np.random.default_rng(2)
    sim = (
        Simulation(space=20.0, cell_size=4.0, boundary="toroidal", dt=1.0,
                   capacity=n, max_per_cell=8, sort_frequency=4, seed=0, device="cpu")
        .add_agents(position=rng.uniform(0, 20, (n, 3)), diameter=1.0, kind=0,
                    nan_bomb_at=np.full(n, 2**30, np.int32))
        .use(behaviors.random_movement(1.0))
        .observe_kinds(n_kinds=2, frequency=2)
    )
    if bomb:
        # The trigger rides agent state, so bombed and clean sessions run one
        # model: which sessions blow up is a request param.
        sim.op(TF.nan_bomb_attr_op("nan_bomb_at"), name="nan_bomb", phase="post")
    return sim.build()


def _solo_series(built, seed, n_steps, params=None):
    state = built.batched().session_state(seed=seed, params=params)
    _, obs = built.run(n_steps, state=state)
    return {k: v.numpy() for k, v in obs.items()}


def test_serve_more_sessions_than_slots_matches_solo_series():
    built = _model()
    reqs = [SessionRequest(name=f"s{i}", n_steps=10, seed=50 + i) for i in range(5)]
    results = serve(built, reqs, slots=2, chunk=4, log=None)
    assert sorted(r.name for r in results) == [f"s{i}" for i in range(5)]
    for r in results:
        assert r.status == "done" and r.steps == 10
        solo = _solo_series(built, 50 + int(r.name[1:]), 10)
        assert set(r.obs) == set(solo)
        for k in solo:
            assert np.array_equal(solo[k], r.obs[k]), (r.name, k)


def test_serve_evicts_nan_session_and_survivors_stay_exact():
    built = _model(bomb=True)
    reqs = [
        SessionRequest(name="clean0", n_steps=12, seed=7),
        SessionRequest(name="sick", n_steps=12, seed=8,
                       params={"attr:nan_bomb_at": np.int32(3)}),
        SessionRequest(name="clean1", n_steps=12, seed=9),
    ]
    results = {r.name: r for r in serve(built, reqs, slots=3, chunk=4, log=None)}
    assert results["sick"].status == "evicted"
    assert results["sick"].health["nonfinite_agents"] >= 1
    assert results["sick"].steps < 12
    for name, seed in (("clean0", 7), ("clean1", 9)):
        r = results[name]
        assert r.status == "done" and r.steps == 12
        assert r.health["nonfinite_agents"] == 0
        solo = _solo_series(built, seed, 12)
        for k in solo:
            assert np.array_equal(solo[k], r.obs[k]), (name, k)


def test_serve_without_eviction_keeps_sick_session_to_budget():
    built = _model(bomb=True)
    reqs = [SessionRequest(name="sick", n_steps=8, seed=4,
                           params={"attr:nan_bomb_at": np.int32(2)})]
    (r,) = serve(built, reqs, slots=1, chunk=4, evict_unhealthy=False, log=None)
    assert r.status == "done" and r.steps == 8
    assert r.health["nonfinite_agents"] >= 1


def test_serve_budget_not_multiple_of_chunk_and_resume_via_state():
    built = _model()
    (first,) = serve(built, [SessionRequest(name="a", n_steps=7, seed=33)],
                     slots=2, chunk=4, log=None)
    assert first.steps == 7  # froze mid-chunk exactly on its budget
    # Re-admit the retired state as a resume to step 11.
    (second,) = serve(built, [SessionRequest(name="a2", n_steps=11, state=first.final)],
                      slots=2, chunk=4, log=None)
    assert second.steps == 11
    solo_final, solo_obs = built.run(11, state=built.batched().session_state(seed=33))
    fa, fb = _leaves_with_paths(solo_final), _leaves_with_paths(second.final)
    for (path, w), (_, g) in zip(fa, fb):
        assert w.numpy().tobytes() == g.numpy().tobytes(), path
    # The two serve legs' series concatenate to the solo series.
    for k, solo in solo_obs.items():
        joined = np.concatenate([first.obs[k], second.obs[k]])
        assert np.array_equal(solo.numpy(), joined), k


def test_serve_rejects_exhausted_injection():
    built = _model()
    (done,) = serve(built, [SessionRequest(name="x", n_steps=4, seed=1)],
                    slots=1, chunk=4, log=None)
    with pytest.raises(ValueError, match="already at step"):
        serve(built, [SessionRequest(name="x2", n_steps=4, state=done.final)],
              slots=1, chunk=4, log=None)


def test_evicted_state_restores_through_the_checkpoint_store_and_resumes(tmp_path):
    """An evicted (sick) session saved by the checkpoint store, restored and
    re-injected: its final state equals the store's round trip, and a clean
    session served beside it still equals its solo run."""
    from repro_torch.checkpoint import checkpoint as ckpt

    built = _model(bomb=True)
    reqs = [SessionRequest(name="sick", n_steps=12, seed=8,
                           params={"attr:nan_bomb_at": np.int32(3)})]
    (sick,) = serve(built, reqs, slots=2, chunk=4, log=None)
    assert sick.status == "evicted"
    ckpt.save(str(tmp_path), int(sick.final.step), {"state": sick.final})
    _, back = ckpt.restore(str(tmp_path), {"state": built.state})
    reqs = [SessionRequest(name="resumed", n_steps=12, state=back["state"]),
            SessionRequest(name="clean", n_steps=12, seed=9)]
    results = {r.name: r for r in serve(built, reqs, slots=2, chunk=4,
                                        evict_unhealthy=False, log=None)}
    solo_final, _ = built.run(12 - int(sick.final.step), state=sick.final)
    for (path, w), (_, g) in zip(_leaves_with_paths(solo_final),
                                 _leaves_with_paths(results["resumed"].final)):
        assert w.numpy().tobytes() == g.numpy().tobytes(), path
    assert _series_sha(results["clean"].obs) == _series_sha(_solo_series(built, 9, 12))


def test_abm_serve_command_line_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.abm_serve", "--smoke", "--device", "cpu"],
        check=True, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert "abm serving OK" in out.stdout
    assert out.stdout.count("== solo") == 6
