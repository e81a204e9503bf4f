"""The port's checkpoint store and checkpointed facade runs, against the
reference's contract and format.

Three layers, as in tests/test_checkpoint.py:
  * the store — atomic save, injective tagged keys, strict shape / dtype /
    presence checks on restore, keep-GC — on the port's own store;
  * one on-disk format — the same state through both packages' flatteners
    gives the same keys, arrays and dtypes, and a run checkpoint written by
    either package resumes in the other;
  * the port's own resume: k steps + kill + resume + k steps equals 2k steps
    straight, bit for bit, in state and every observable series.

Tolerances across packages (the parity contract): alive flags and kind
counts exact; positions and the position series ``atol=1e-4``, as
tests/test_torch_engine.py.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import checkpoint as j_ckpt
from repro_torch.checkpoint import latest_step, list_steps, read_manifest, restore, save
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, _path_key
from torch_parity import CPU, to_np


# ------------------------------------------------------------------- store

def test_roundtrip_with_meta(tmp_path):
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.float32(1.5)}}
    save(str(tmp_path), 7, tree, meta={"engine": "single", "target_step": 20})
    step, back = restore(str(tmp_path), tree)
    assert step == 7
    np.testing.assert_array_equal(back["a"], tree["a"])
    step, manifest = read_manifest(str(tmp_path))
    assert step == 7
    assert manifest["meta"] == {"engine": "single", "target_step": 20}


def test_tensor_leaves_keep_dtype_and_device(tmp_path):
    """Tensors go to the host on save and come back as tensors of the same
    dtype on the ``like`` leaf's device — the uint32 threefry key included,
    with no cast through a signed type."""
    from repro_torch.core import prng

    tree = {"key": prng.PRNGKey(2**33 + 7), "alive": torch.tensor([True, False]),
            "pos": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": torch.tensor(3, dtype=torch.int32)}
    save(str(tmp_path), 1, tree)
    _, back = restore(str(tmp_path), tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].device == v.device, k
        assert torch.equal(back[k], v), k
    assert back["key"].dtype == torch.uint32
    with np.load(os.path.join(str(tmp_path), "step_0000000001", "arrays.npz")) as z:
        assert z[_path_key((("k", "key"),))].dtype == np.uint32


def test_injective_keys_slash_in_dict_key(tmp_path):
    """``{"a/b": x}`` and ``{"a": {"b": y}}`` must not share an array key."""
    tree = {"a/b": np.float32(1.0), "a": {"b": np.float32(2.0)}}
    save(str(tmp_path), 1, tree)
    _, back = restore(str(tmp_path), tree)
    assert float(back["a/b"]) == 1.0
    assert float(back["a"]["b"]) == 2.0


def test_path_key_tags_make_entry_types_distinct():
    """dict key 1, dict key "1", sequence index 1, flattened index 1 and
    attribute "1" map to five different array keys."""
    keys = {_path_key(((kind, v),))
            for kind, v in (("k", 1), ("k", "1"), ("i", 1), ("x", 1), ("a", "1"))}
    assert len(keys) == 5, keys


def test_missing_leaf_raises_stale(tmp_path):
    save(str(tmp_path), 1, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stale or foreign"):
        restore(str(tmp_path), {"y": np.zeros(3, np.float32)})


@pytest.mark.parametrize("like", [np.zeros(3, np.int32), torch.zeros(3, dtype=torch.int32)],
                         ids=["numpy", "tensor"])
def test_dtype_mismatch_raises(tmp_path, like):
    save(str(tmp_path), 1, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore(str(tmp_path), {"x": like})


@pytest.mark.parametrize("like", [np.zeros(4, np.float32), torch.zeros(4)],
                         ids=["numpy", "tensor"])
def test_shape_mismatch_raises(tmp_path, like):
    save(str(tmp_path), 1, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), {"x": like})


def test_extra_arrays_ignored(tmp_path):
    """``like`` may be a sub-structure of what was saved."""
    save(str(tmp_path), 1, {"x": np.ones(2, np.float32), "extra": np.zeros(5)})
    _, back = restore(str(tmp_path), {"x": np.ones(2, np.float32)})
    np.testing.assert_array_equal(back["x"], np.ones(2, np.float32))


def test_latest_step_skips_incomplete_manifest(tmp_path):
    tree = {"x": np.zeros(2, np.float32)}
    save(str(tmp_path), 3, tree)
    save(str(tmp_path), 6, tree)
    mf = os.path.join(str(tmp_path), "step_0000000006", "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["complete"] = False
    with open(mf, "w") as f:
        json.dump(manifest, f)
    assert latest_step(str(tmp_path)) == 3
    step, _ = restore(str(tmp_path), tree)
    assert step == 3


@settings(max_examples=5, deadline=None)
@given(
    steps=st.lists(st.integers(0, 40), min_size=1, max_size=10),
    keep=st.integers(1, 5),
)
def test_gc_keeps_exactly_last_k(steps, keep):
    """After saving any step sequence with ``keep=k``, exactly the k highest
    steps survive.  Own tempdir: the hypothesis fallback injects no
    fixtures."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="ckpt_gc_")
    steps = list(dict.fromkeys(steps))
    try:
        tree = {"x": np.zeros(2, np.float32)}
        for s in steps:
            save(d, s, tree, keep=keep)
        assert list_steps(d) == sorted(steps)[-keep:]
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------- one format

SPACE = 30.0


def _model(pkg, **attrs):
    """tests/test_checkpoint.py's model, declared through ``pkg``'s facade
    ("jax" or "torch", the latter on the CPU), with ``attrs`` added."""
    rng = np.random.RandomState(11)
    pos = rng.uniform(3.0, SPACE - 3.0, (40, 3)).astype(np.float32)
    kw = dict(space=SPACE, cell_size=3.0, boundary="closed", dt=0.05, capacity=64,
              seed=5, sort_frequency=4)
    if pkg == "jax":
        from repro.core import ForceParams
        from repro.core.api import Simulation

        com = lambda s: s.pool.position[s.pool.alive.argmax()]
    else:
        from repro_torch import Simulation
        from repro_torch.core import ForceParams

        kw["device"] = "cpu"
        com = lambda s: s.pool.position[s.pool.alive.to(torch.int32).argmax()]
    return (
        Simulation(**kw)
        .add_agents(position=pos, diameter=2.5, kind=rng.randint(0, 2, 40), **attrs)
        .mechanics(ForceParams())
        .observe_kinds("counts", n_kinds=2)
        .observe("com", com, frequency=3)
    )


def _rich_model(pkg):
    """A state with every kind of leaf: free-form attrs, two substances
    (whose static metadata must not become arrays) and a key of a seed
    beyond 32 bits."""
    m = _model(pkg, energy=1.5, tag=np.arange(40, dtype=np.int32))
    m.seed = 2**33 + 9
    m.add_substance("b_field", diffusion=1.0, decay=0.1, resolution=4)
    m.add_substance("a_field", diffusion=2.0, resolution=4)
    return m


def test_flattened_keys_arrays_and_dtypes_match_the_reference():
    """One state through both flatteners: identical key strings in the same
    order, equal arrays, equal dtypes."""
    from repro.core.behaviors import brownian_motion as j_brownian
    from repro_torch import convert
    from torch_parity import jax_state_to_numpy

    j_sim = _rich_model("jax").use(j_brownian(0.1))
    j_state, _ = j_sim.build().run_jit(3)
    t_state = convert.state_from_numpy(jax_state_to_numpy(j_state), CPU)
    obs = {"counts": np.arange(6, dtype=np.int32).reshape(3, 2),
           "com": np.ones((1, 3), np.float32)}
    j_flat = j_ckpt._flatten_with_paths({"state": j_state, "obs": obs})
    t_flat = _flatten_with_paths({"state": t_state, "obs": obs})
    assert list(t_flat) == list(j_flat)
    assert "k:'state'/a:grids/k:'a_field'/a:concentration" in t_flat
    assert "k:'state'/a:pool/a:attrs/k:'tag'" in t_flat
    assert not any("spacing" in k or "origin" in k for k in t_flat)
    for k in j_flat:
        assert t_flat[k].dtype == j_flat[k].dtype, k
        np.testing.assert_array_equal(t_flat[k], j_flat[k], err_msg=k)
    assert t_flat["k:'state'/a:rng"].dtype == np.uint32


class _Die(Exception):
    pass


def _killer(at):
    def kill(state):
        if int(np.asarray(to_np(state.step))) >= at:
            raise _Die
    return kill


def _assert_parity(final, obs, ref_final, ref_obs):
    assert np.array_equal(to_np(final.pool.alive), to_np(ref_final.pool.alive))
    assert np.array_equal(to_np(final.pool.kind), to_np(ref_final.pool.kind))
    np.testing.assert_allclose(to_np(final.pool.position), to_np(ref_final.pool.position),
                               atol=1e-4)
    assert int(to_np(final.step)) == int(to_np(ref_final.step))
    assert set(obs) == set(ref_obs)
    np.testing.assert_array_equal(to_np(obs["counts"]), to_np(ref_obs["counts"]))
    np.testing.assert_allclose(to_np(obs["com"]), to_np(ref_obs["com"]), atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_run_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """12 steps straight in the reference == 6 steps written by one package,
    killed, then resumed by the other from the description alone."""
    reader = {"jax": "torch", "torch": "jax"}[writer]
    ref_final, ref_obs = _model("jax").run_jit(12)
    d = str(tmp_path / "ckpt")
    with pytest.raises(_Die):
        _model(writer).run_jit(12, checkpoint_dir=d, checkpoint_every=3,
                               on_chunk=_killer(6))
    assert latest_step(d) == 6
    final, obs = _model(reader).resume(d)
    _assert_parity(final, obs, ref_final, ref_obs)


# ---------------------------------------------------- the port's own resume

def _assert_runs_equal(a, b):
    fa, oa = a
    fb, ob = b
    ka, kb = _flatten_with_paths(fa), _flatten_with_paths(fb)
    assert list(ka) == list(kb)
    for k in ka:
        assert ka[k].dtype == kb[k].dtype, k
        np.testing.assert_array_equal(ka[k], kb[k], err_msg=k)
    assert set(oa) == set(ob)
    for name in oa:
        assert oa[name].dtype == ob[name].dtype, name
        np.testing.assert_array_equal(to_np(oa[name]), to_np(ob[name]), err_msg=name)


@pytest.mark.parametrize("jit", [True, False])
def test_resume_bit_exact_single_node(tmp_path, jit):
    """2k steps straight == k steps + process death + resume + k steps, bit
    for bit: final state AND every series (frequency 1 and 3)."""
    straight = _model("torch").run_jit(12) if jit else _model("torch").run(12)
    d = str(tmp_path / "ckpt")
    with pytest.raises(_Die):
        run = _model("torch").run_jit if jit else _model("torch").run
        run(12, checkpoint_dir=d, checkpoint_every=3, on_chunk=_killer(6))
    _assert_runs_equal(straight, _model("torch").resume(d, jit=jit))


def test_checkpointed_run_equals_straight_run(tmp_path):
    """An uninterrupted checkpointed run returns the straight run's state and
    series; its anchor and chunk checkpoints are on disk with run meta."""
    straight = _model("torch").run(7)
    d = str(tmp_path / "ckpt")
    got = _model("torch").run(7, checkpoint_dir=d, checkpoint_every=3, keep=10)
    _assert_runs_equal(straight, got)
    assert list_steps(d) == [0, 3, 6, 7]
    _, manifest = read_manifest(d)
    assert manifest["meta"]["target_step"] == 7
    assert manifest["meta"]["obs_rows"] == {"com": 3, "counts": 7}


def test_resume_completed_run_returns_series(tmp_path):
    """Resume of a finished run re-reads the checkpoint and hands back the
    complete series without stepping."""
    d = str(tmp_path / "ckpt")
    done = _model("torch").run_jit(6, checkpoint_dir=d, checkpoint_every=2)
    _assert_runs_equal(done, _model("torch").resume(d))


def test_resume_rejects_plain_checkpoint(tmp_path):
    built = _model("torch").build()
    save(str(tmp_path), 4, {"state": built.state, "obs": {}})
    with pytest.raises(ValueError, match="not an ABM run checkpoint"):
        _model("torch").resume(str(tmp_path))


def test_resume_rejects_wrong_capacity(tmp_path):
    d = str(tmp_path / "ckpt")
    _model("torch").run_jit(4, checkpoint_dir=d, checkpoint_every=2)
    bigger = _model("torch")
    bigger.capacity = 128
    with pytest.raises(ValueError, match="shape mismatch"):
        bigger.resume(d)


def test_resume_rejects_wrong_engine(tmp_path):
    """A run checkpoint of the distributed engine does not resume on the
    single-node one."""
    from repro_torch.core.api import CKPT_FORMAT

    built = _model("torch").build()
    save(str(tmp_path), 0, {"state": built.state, "obs": {}},
         meta={"format": CKPT_FORMAT, "engine": "distributed", "target_step": 4,
               "checkpoint_every": 2, "obs_rows": {}})
    with pytest.raises(ValueError, match="cannot resume on 'single'"):
        _model("torch").resume(str(tmp_path))
