"""The port's LM training (dense and MoE configs, AdamW, the train step)
against the reference on the CPU.

* ``Model.loss``: the value, the metrics and every gradient leaf against
  ``jax.value_and_grad(model.loss)`` for the dense and MoE configs of
  ``configs/archs.py`` at reduced size, f32 (``tests/torch_train_cases.py``
  states the tolerances); the MoE router's expert ids exact.  The other
  families are in ``test_torch_train_families.py``.
* ``adamw.apply`` with and without clipping at steps 1, the last warmup
  step, mid-decay and the last: parameters and moments ``rtol=4e-6,
  atol=1e-8``, ``grad_norm`` and ``lr`` ``rtol=1e-6`` (f32 ops in the
  reference's order; XLA's and torch's ``pow``, ``cos`` and sums may differ
  by an ulp, and an ulp of the clip scale moves every moment by one; seen
  1.9e-9 at one of 72 values).
* Three ``make_train_step`` steps of reduced phi4-mini, and of one arch a
  family with ``remat=True`` (``TRAIN_STEP_CASES``), against the
  reference's jitted step from the same state: loss and ``ce`` ``rtol=2e-6``,
  ``grad_norm`` ``rtol=1e-5``, ``lr`` ``rtol=1e-6``, parameters
  ``atol=2e-5`` (AdamW moves a parameter by about ``lr`` a step whatever its
  gradient's size; lr ≤ 3e-4·3/20 here; seen ≤ 1e-7), moments as the
  parameters scaled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np
from torch_train_cases import check_loss_and_grads

from repro import training as jax_training
from repro.configs import reduced_config as jax_reduced_config
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch import convert, training
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

DENSE_MOE = sorted(a for a, c in ARCHS.items() if c.family in ("dense", "moe"))


@pytest.mark.parametrize("arch", DENSE_MOE)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    calls = []
    topk = moe_mod.topk_lower_first
    monkeypatch.setattr(moe_mod, "topk_lower_first",
                        lambda probs, k: calls.append((probs.detach(), topk(probs, k)[1]))
                        or topk(probs, k))
    check_loss_and_grads(arch)
    assert bool(calls) == ARCHS[arch].is_moe
    for probs, ids in calls:
        # The reference's router on the same probabilities: jax.lax.top_k.
        want = to_np(jax.lax.top_k(jnp.asarray(to_np(probs)), ids.shape[-1])[1])
        np.testing.assert_array_equal(to_np(ids), want)


def _adamw_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"w": (3, 4, 6), "z": (9,)}}
    mk = lambda scale, f=lambda x: x: jax.tree.map(
        lambda s: f(rng.normal(0, scale, s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    return mk(1.0), mk(0.05), mk(0.01), mk(0.01, np.square)   # params, grads, mu, nu


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("step", [1, 20, 60, 100])
def test_adamw_apply_matches_jax(step, clip):
    params, grads, mu, nu = _adamw_case(step)
    if clip:
        grads = jax.tree.map(lambda g: g * 10, grads)          # norm ≈ 4.5 > clip
    cfg_kw = dict(learning_rate=3e-3, warmup_steps=20, total_steps=100, clip_norm=clip)
    state_w = jax_adamw.AdamWState(step=jnp.int32(step - 1), mu=jax.tree.map(jnp.asarray, mu),
                                   nu=jax.tree.map(jnp.asarray, nu))
    p_w, s_w, m_w = jax_adamw.apply(jax_adamw.AdamWConfig(**cfg_kw), state_w,
                                    jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, grads))
    tt = lambda tree: convert.lm_params_from_numpy(tree, "cpu")
    state = adamw.AdamWState(step=torch.tensor(step - 1, dtype=torch.int32), mu=tt(mu),
                             nu=tt(nu))
    p, s, m = adamw.apply(adamw.AdamWConfig(**cfg_kw), state, tt(params), tt(grads))
    assert int(s.step) == int(s_w.step) == step
    np.testing.assert_allclose(float(m["lr"]), float(m_w["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_w["grad_norm"]), rtol=1e-6)
    for got, want in ((p, p_w), (s.mu, s_w.mu), (s.nu, s_w.nu)):
        for a, b in zip(jax.tree.leaves(convert.lm_params_to_numpy(got)), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, to_np(b), rtol=4e-6, atol=1e-8)


def test_schedule_matches_jax():
    cfg = dict(learning_rate=1e-3, warmup_steps=7, total_steps=50, min_lr_ratio=0.2)
    for step in (0, 1, 6, 7, 8, 30, 49, 50, 60):
        want = float(jax_adamw.schedule(jax_adamw.AdamWConfig(**cfg), jnp.int32(step)))
        got = float(adamw.schedule(adamw.AdamWConfig(**cfg),
                                   torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


# (arch, remat): phi4-mini as the reduced config has it, and one arch a
# family with ``remat=True`` in both packages: the MoE router, the VLM's
# prefix mask, rwkv6's chunked WKV, the RG-LRU scan and local window,
# whisper's encoder and cross-attention, gemma's D 256 at group 1 and
# command-r's LayerNorm.
TRAIN_STEP_CASES = [("phi4-mini-3.8b", False), ("olmoe-1b-7b", True), ("paligemma-3b", True),
                    ("rwkv6-1.6b", True), ("recurrentgemma-9b", True), ("whisper-base", True),
                    ("gemma-7b", True), ("command-r-35b", True)]


@pytest.mark.parametrize("arch,remat", TRAIN_STEP_CASES, ids=[a for a, _ in TRAIN_STEP_CASES])
def test_train_steps_match_jax(arch, remat):
    cj = dataclasses.replace(jax_reduced_config(arch), attention_impl="chunked", remat=remat)
    mj = jax_build_model(cj)
    mt = build_model(dataclasses.replace(reduced_config(arch), attention_impl="cuda",
                                         remat=remat))
    opt_w = jax_adamw.AdamWConfig(learning_rate=3e-4, warmup_steps=20, total_steps=100)
    opt_t = adamw.AdamWConfig(learning_rate=3e-4, warmup_steps=20, total_steps=100)
    state_w, _ = jax_training.init_train_state(mj, jax.random.PRNGKey(0))
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, state_w), "cpu")
    step_w = jax.jit(jax_training.make_train_step(mj, opt_w))
    step_t = training.make_train_step(mt, opt_t)
    rng = np.random.default_rng(5)
    for i in range(3):
        toks = rng.integers(0, cj.vocab_size, (2, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cj.family == "vlm":
            batch["patches"] = rng.normal(0, 1, (2, cj.prefix_tokens, cj.d_model)
                                          ).astype(np.float32)
        if cj.is_encoder_decoder:
            batch["frames"] = rng.normal(0, 1, (2, cj.encoder_seq, cj.d_model)).astype(np.float32)
        state_w, met_w = step_w(state_w, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step_t(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(met) == set(met_w) | {"loss"} == set(met_w)
        for k, rtol in (("loss", 2e-6), ("ce", 2e-6), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(met[k]), float(met_w[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
        assert int(state.step) == int(state_w.step) == int(state.opt.step) == i + 1
    back = convert.train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(state_w.params)):
        np.testing.assert_allclose(a, to_np(b), atol=2e-5, rtol=0)
    for a, b in zip(jax.tree.leaves(back.opt.mu), jax.tree.leaves(state_w.opt.mu)):
        np.testing.assert_allclose(a, to_np(b), atol=1e-6, rtol=1e-4)


def test_train_entry_points_need_a_card_unless_cpu(monkeypatch):
    mt = build_model(reduced_config("phi4-mini-3.8b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.init_train_state(mt, 0)
    state = training.init_train_state(mt, 0, "cpu")
    assert int(state.step) == 0 and state.opt.mu["embed"]["table"].dtype == torch.float32
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "phi4-mini-3.8b", "--reduced", "--steps", "1"])
