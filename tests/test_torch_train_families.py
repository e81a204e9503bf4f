"""The port's LM training on the other families, its data pipeline, its
training driver and its compressed all-reduce, against the reference on
the CPU.

* ``Model.loss`` and every gradient leaf for the VLM, rwkv6, hybrid and
  encoder–decoder configs at reduced size, f32 (``tests/torch_train_cases.py``
  states the tolerances; dense and MoE are in ``test_torch_train.py``).
* ``data.host_batch`` bit for bit against the reference's for dense, VLM
  and audio configs, and ``device_batch`` the same arrays as tensors.
* ``launch/train.py``: a run killed after its step-3 checkpoint and run
  again resumes there; its losses and its final checkpoint equal a straight
  run's bit for bit.
* ``optim.compression``: each rank's mean and new error against the
  reference's ``compressed_psum_leaf`` (under ``jax.vmap`` with the axis
  name, which gives ``psum`` its meaning); int32 payload sums exact, the
  means and errors ``rtol=1e-6, atol=1e-7`` (f32 scale sums in another
  order); the wire bytes exact.
* ``convert.train_state_from_numpy`` / ``train_state_to_numpy`` round trip
  the reference's train state bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np
from torch_train_cases import check_loss_and_grads

from repro import training as jax_training
from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import host_batch as jax_host_batch
from repro.models.model import build_model as jax_build_model
from repro.optim import compression as jax_compression
from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.data import DataConfig, device_batch, host_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import compression

FAMILIES = sorted(a for a, c in ARCHS.items() if c.family not in ("dense", "moe"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "paligemma-3b", "whisper-base"])
def test_host_batch_is_the_reference_batch(arch):
    cfg = reduced_config(arch)
    dk = dict(seed=3, batch=3, seq_len=20)
    for step in (0, 7):
        got = host_batch(DataConfig(**dk), cfg, step)
        want = jax_host_batch(JaxDataConfig(**dk), jax_reduced_config(arch), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        on = device_batch(DataConfig(**dk), cfg, step, "cpu")
        for k in want:
            assert on[k].numpy().tobytes() == want[k].tobytes(), k


def test_train_resume_equals_a_straight_run(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train

    args = ["--arch", "phi4-mini-3.8b", "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "3", "--log-every", "1"]
    straight = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])

    class Killed(Exception):
        pass

    real = train.device_batch

    def dies_at_step_4(cfg, model_cfg, step, device):
        if step == 4:
            raise Killed
        return real(cfg, model_cfg, step, device)

    run_b = args + ["--ckpt-dir", str(tmp_path / "b")]
    monkeypatch.setattr(train, "device_batch", dies_at_step_4)
    with pytest.raises(Killed):
        train.main(run_b)
    assert latest_step(str(tmp_path / "b")) == 3
    monkeypatch.setattr(train, "device_batch", real)
    capsys.readouterr()
    resumed = train.main(run_b)
    assert "resumed from checkpoint step 3" in capsys.readouterr().out
    assert len(straight) == 6 and resumed == straight[3:]
    like = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_training.init_train_state(
            jax_build_model(jax_reduced_config("phi4-mini-3.8b")), jax.random.PRNGKey(0))[0]),
        "cpu")
    (sa, a), (sb, b) = restore(str(tmp_path / "a"), like), restore(str(tmp_path / "b"), like)
    assert sa == sb == 6 and int(a.step) == int(b.step) == 6
    for x, y in zip(jax.tree.leaves(convert.train_state_to_numpy(a)),
                    jax.tree.leaves(convert.train_state_to_numpy(b))):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("wire", ["int8", "int16"])
def test_compressed_psum_leaf_matches_jax(wire):
    r = 4
    rng = np.random.default_rng(2)
    g = rng.normal(0, 1, (r, 33, 5)).astype(np.float32) * np.arange(1, r + 1)[:, None, None]
    e = rng.normal(0, 1e-3, g.shape).astype(np.float32)
    jd, td = getattr(jnp, wire), getattr(torch, wire)
    means_w, errs_w = jax.vmap(
        lambda g_, e_: jax_compression.compressed_psum_leaf(g_, e_, "data", jd),
        axis_name="data")(jnp.asarray(g), jnp.asarray(e))
    mesh = make_mesh((r,), ("data",), devices="cpu")
    means, errs = compression.compressed_psum_leaf(
        mesh, [torch.from_numpy(x) for x in g], [torch.from_numpy(x) for x in e], "data", td)
    for i in range(r):
        np.testing.assert_allclose(to_np(means[i]), to_np(means_w[i]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(to_np(errs[i]), to_np(errs_w[i]), rtol=1e-6, atol=1e-7)
    # Twelve steps of error feedback on one gradient scaled by rank: the
    # reference test's accuracy bounds, the tree wrapper over two leaves.
    x = {"w": torch.from_numpy(rng.normal(0, 1, (256,)).astype(np.float32)),
         "b": {"v": torch.from_numpy(rng.normal(0, 1, (8, 3)).astype(np.float32))}}
    fn = compression.make_compressed_grad_allreduce(mesh, td)
    grads = [jax.tree.map(lambda t, s=i + 1.0: t * s, x) for i in range(r)]
    errs = [compression.init_error_state(x) for _ in range(r)]
    true = jax.tree.map(lambda t: t * ((1 + 2 + 3 + 4) / 4.0), x)
    rel = []
    for _ in range(12):
        out, errs = fn(grads, errs)
        rel.append(max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(jax.tree.leaves(out[0]), jax.tree.leaves(true))))
    assert rel[0] < 0.15 and min(rel) < 0.05, rel
    n = 256 + 24
    assert compression.compression_wire_bytes(x, td) == (n * td.itemsize, 4 * n)


def test_train_state_round_trips_the_reference_state():
    mj = jax_build_model(jax_reduced_config("rwkv6-1.6b"))
    state_w, _ = jax_training.init_train_state(mj, jax.random.PRNGKey(4))
    state_np = jax.tree.map(np.asarray, state_w)
    back = convert.train_state_to_numpy(convert.train_state_from_numpy(state_np, "cpu"))
    assert list(back._fields) == list(state_w._fields)
    assert list(back.opt._fields) == list(state_w.opt._fields)
    la, lb = jax.tree.leaves(state_np), jax.tree.leaves(back)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == np.asarray(b).dtype and a.tobytes() == np.asarray(b).tobytes()
