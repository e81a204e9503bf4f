"""Fault injection on the port (tests/test_faults.py's suite, on the CPU).

Checkpoint-store faults → the latest *valid* interval wins and mid-write
debris is invisible.  State faults → the scheduler's health op trips the
matching counter without corrupting the step, and the elastic policy maps
each counter to the designed response (grow / halt / continue).  File
injectors come from tests/faults.py, model injectors from
tests/torch_faults.py.  The last test holds ``run_elastic`` to the
reference's: the same regrow count and the same population series, exactly.
"""

import numpy as np
import pytest
import torch

import faults
import torch_faults
from repro_torch.checkpoint import latest_step, list_steps, restore, save
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, _leaves_with_paths
from repro_torch.launch import elastic
from torch_parity import to_np


# ----------------------------------------------------- checkpoint-store tier

def test_latest_valid_wins_after_corruption(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    for s in (2, 4, 6):
        save(d, s, {"x": tree["x"] * s})
    faults.truncate_arrays(d, 6)
    assert latest_step(d) == 4
    step, back = restore(d, tree)
    assert step == 4
    assert torch.equal(back["x"], tree["x"] * 4)
    faults.corrupt_manifest(d, 4)
    step, back = restore(d, tree)
    assert step == 2


def test_missing_payload_with_complete_manifest_invalid(tmp_path):
    d = str(tmp_path)
    save(d, 1, {"x": np.zeros(2, np.float32)})
    faults.fake_complete_manifest(d, 9)
    assert latest_step(d) == 1
    save(d, 3, {"x": np.zeros(2, np.float32)})
    faults.delete_arrays(d, 3)
    assert latest_step(d) == 1


def test_mid_write_tmp_dir_invisible(tmp_path):
    d = str(tmp_path)
    save(d, 5, {"x": np.zeros(2, np.float32)})
    faults.leftover_tmp_dir(d)
    assert list_steps(d) == [5]
    step, _ = restore(d, {"x": np.zeros(2, np.float32)})
    assert step == 5


def test_resume_skips_corrupt_latest(tmp_path):
    """The final save died mid-write: resume falls back to the previous
    interval and still finishes bit for bit."""
    straight_final, straight_obs = torch_faults.dividing_sim(256).run_jit(6)
    d = str(tmp_path / "ckpt")
    torch_faults.dividing_sim(256).run_jit(6, checkpoint_dir=d, checkpoint_every=2)
    faults.truncate_arrays(d, 6)
    resumed_final, resumed_obs = torch_faults.dividing_sim(256).resume(d)
    assert torch.equal(straight_obs["pop"], resumed_obs["pop"])
    assert torch.equal(straight_final.pool.position, resumed_final.pool.position)


def test_foreign_checkpoint_fails_loudly(tmp_path):
    """A model that accounts for fewer arrays than the checkpoint holds (an
    attr column dropped) raises instead of restoring a subset."""
    from repro_torch import Simulation

    rng = np.random.RandomState(0)
    pos = rng.uniform(2.0, 18.0, (8, 3)).astype(np.float32)
    kw = dict(space=20.0, cell_size=3.0, capacity=16, seed=1, device="cpu")
    d = str(tmp_path / "ckpt")
    Simulation(**kw).add_agents(position=pos, diameter=2.0, energy=1.0).run_jit(
        2, checkpoint_dir=d)
    without_attr = Simulation(**kw).add_agents(position=pos, diameter=2.0)
    with pytest.raises(ValueError, match="stale or foreign"):
        without_attr.resume(d)


# ------------------------------------------------------------ health op tier

def test_nan_injection_trips_health_and_halts():
    sim = torch_faults.dividing_sim(256, division_probability=0.0)
    sim.op(torch_faults.nan_bomb_op(at_step=2), name="nan_bomb", phase="post")
    final, _ = sim.build().run_jit(5)
    assert int(final.health.nonfinite_agents) >= 1
    assert int(final.health.nonfinite_steps) >= 1
    action = elastic.check_abm_state(final.health)
    assert action.kind == "halt"
    assert "non-finite" in action.reason


def test_nan_halts_elastic_run(tmp_path):
    sim = torch_faults.dividing_sim(256, division_probability=0.0)
    sim.op(torch_faults.nan_bomb_op(at_step=1), name="nan_bomb", phase="post")
    with pytest.raises(RuntimeError, match="halted"):
        elastic.run_elastic(sim, 4, str(tmp_path / "ckpt"), checkpoint_every=2)


def test_pool_overflow_trips_health_and_grow_action():
    final, _ = torch_faults.dividing_sim(32).run_jit(4)
    assert int(final.health.pool_overflow) > 0
    action = elastic.check_abm_state(final.health, grow_factor=2.0)
    assert action.kind == "grow_capacity"
    assert action.grow_factor == 2.0


def test_cell_overflow_trips_health_and_dense_fallback_is_bit_exact():
    """An over-full neighbor cell raises the health flag and leaves physics
    bit-identical to the dense path; the policy does not regrow on it."""
    fused_final, _ = torch_faults.overfull_cell_sim(impl="fused").run_jit(3)
    dense_final, _ = torch_faults.overfull_cell_sim(impl="reference").run_jit(3)
    assert torch.equal(fused_final.pool.position, dense_final.pool.position)
    assert int(fused_final.health.cell_overflow_steps) > 0
    assert elastic.check_abm_state(fused_final.health).kind == "continue"


# --------------------------------------------------------- elastic regrowth

def test_elastic_regrowth_end_to_end(tmp_path):
    """Saturation → restore into a bigger pool → replay, until the run ends
    with zero drops; the whole trajectory is deterministic."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    f1, o1, g1 = elastic.run_elastic(torch_faults.dividing_sim(32), 6, d1,
                                     checkpoint_every=2)
    assert g1 >= 1
    assert int(f1.pool.overflow) == 0
    assert int(f1.health.pool_overflow) == 0
    assert f1.pool.position.shape[0] > 32
    assert int(o1["pop"][-1]) == int(f1.pool.alive.sum())

    f2, o2, g2 = elastic.run_elastic(torch_faults.dividing_sim(32), 6, d2,
                                     checkpoint_every=2)
    assert g2 == g1
    assert torch.equal(o1["pop"], o2["pop"])
    a, b = _flatten_with_paths(f1), _flatten_with_paths(f2)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_grow_state_bit_identical_modulo_padding():
    state, _ = torch_faults.dividing_sim(32, division_probability=0.0).build().run_jit(2)
    grown = elastic.grow_state(state, 80)
    assert grown.pool.position.shape[0] == 80
    assert torch.equal(grown.pool.position[:32], state.pool.position)
    assert torch.equal(grown.pool.alive[:32], state.pool.alive)
    assert not bool(grown.pool.alive[32:].any())
    assert int(grown.pool.overflow) == 0
    assert {leaf.device for _, leaf in _leaves_with_paths(grown)} == {state.pool.device}


# ------------------------------------------------------------ the reference

def test_run_elastic_matches_the_reference(tmp_path):
    """run_elastic on dividing_sim(32) regrows as often and records the same
    population series in both packages (the threefry draws are bit-exact)."""
    import jax

    from repro.launch import elastic as j_elastic

    jf, jo, jg = j_elastic.run_elastic(faults.dividing_sim(32), 6, str(tmp_path / "j"),
                                       checkpoint_every=2)
    tf, to, tg = elastic.run_elastic(torch_faults.dividing_sim(32), 6, str(tmp_path / "t"),
                                     checkpoint_every=2)
    assert tg == jg >= 1
    np.testing.assert_array_equal(to_np(to["pop"]), np.asarray(jax.device_get(jo["pop"])))
    assert tf.pool.capacity == jf.pool.position.shape[0]
    assert np.array_equal(to_np(tf.pool.alive), to_np(jf.pool.alive))


@pytest.mark.parametrize("hosts,per_host,mp", [(3, 4, 16), (10, 4, 16), (8, 8, 4), (1, 1, 1)])
def test_surviving_mesh_shape_matches_the_reference(hosts, per_host, mp):
    from repro.launch import elastic as j_elastic

    assert elastic.surviving_mesh_shape(hosts, per_host, mp) == \
        j_elastic.surviving_mesh_shape(hosts, per_host, mp)
    shape = elastic.surviving_mesh_shape(hosts, per_host, mp)
    if shape is not None:
        assert f"mesh {shape}" in elastic.reshard_plan((2 * shape[0], mp), shape)


@pytest.mark.parametrize("as_", ["tensor", "numpy"])
def test_elastic_policies(as_):
    """tests/test_substrate.py's policy table on the port's reports: tensor
    counters (read in one device read) or numpy ones, stacked per device."""
    from repro_torch.core.schedule import HEALTH_FIELDS, HealthReport

    conv = ((lambda v: torch.as_tensor(np.asarray(v, np.int32))) if as_ == "tensor"
            else (lambda v: np.asarray(v, np.int32)))

    def report(**kw):
        return HealthReport(**{f: conv(kw.get(f, 0)) for f in HEALTH_FIELDS})

    assert elastic.check_abm_state(report()).kind == "continue"
    act = elastic.check_abm_state(report(pool_overflow=5))
    assert act.kind == "grow_capacity" and act.grow_factor == 2.0
    act = elastic.check_abm_state(report(halo_overflow=2), grow_factor=1.5)
    assert act.kind == "grow_capacity" and act.grow_factor == 1.5
    act = elastic.check_abm_state(report(pool_overflow=5, nonfinite_agents=1,
                                         nonfinite_steps=1))
    assert act.kind == "halt"
    assert elastic.check_abm_state(report(cell_overflow_steps=3)).kind == "continue"
    assert elastic.check_abm_state(
        report(migrate_overflow=np.zeros(4, np.int32))).kind == "continue"
    assert elastic.check_abm_state(
        report(migrate_overflow=[0, 0, 3, 0])).kind == "grow_capacity"
    assert elastic.check_abm_state(object()).kind == "continue"
