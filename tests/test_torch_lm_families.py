"""The LM families ported last — the VLM prefix path (paligemma), MoE
(olmoe), rwkv6, the rglru hybrid (recurrentgemma) and the encoder–decoder
(whisper) — through the port's entry points against the reference on the
CPU, at reduced configs in f32.

``training.make_prefill_step`` and prompt + 8 greedy ``decode_step``s
against the reference's (jitted): logits ``atol=5e-5``, tokens equal
(tolerance as in ``tests/test_torch_lm.py``).  The recurrentgemma prompt is
longer than its reduced window of 16, so the decode ring wraps.  For rwkv6
and recurrentgemma the port's decode of the prompt agrees with its own
prefill within the same tolerance.  Two quirks of the reference are held
(ROADMAP §3): a VLM decode cache never holds the patches' K/V, and
whisper's ``cross_kv`` stays zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import ATOL, _pair, lm_batch
from torch_parity import to_np

from repro import training as jax_training
from repro_torch import training
from repro_torch.configs import reduced_config
from repro_torch.models.params import tree_leaves

FAMILIES = ["paligemma-3b", "olmoe-1b-7b", "rwkv6-1.6b", "recurrentgemma-9b", "whisper-base"]
PROMPT, GEN = 20, 8


def _greedy(lg):
    return lg[:, -1].argmax(-1)[:, None]


def _decode_both(mj, pj, mt, pt, prompt, cache_len, enc_out=None):
    """The prompt then GEN greedy tokens through both decode steps; checks
    every step's logits and token; returns the port's logits after the
    prompt and its cache."""
    b = prompt.shape[0]
    cj = mj.init_cache(b, cache_len, enc_out)
    ct = mt.init_cache(b, cache_len, "cpu")
    step_j = jax.jit(mj.decode_step)
    step_t = training.make_decode_step(mt)
    tj, tt = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    for i in range(prompt.shape[1] + GEN):
        lj, cj = step_j(pj, cj, tj, jnp.int32(i))
        lt, ct = step_t(pt, ct, tt, i)
        np.testing.assert_allclose(lt.numpy(), to_np(lj), atol=ATOL, rtol=0, err_msg=f"step {i}")
        if i == prompt.shape[1] - 1:
            prompt_logits = lt
        if i + 1 < prompt.shape[1]:
            tj, tt = jnp.asarray(prompt[:, i + 1:i + 2]), torch.from_numpy(prompt[:, i + 1:i + 2])
        else:
            tj, tt = _greedy(lj).astype(jnp.int32), _greedy(lt).to(torch.int32)
            np.testing.assert_array_equal(tt.numpy(), to_np(tj), err_msg=f"step {i}")
    return prompt_logits, ct


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch):
    mj, pj, mt, pt = _pair(arch, jax_impl="reference", port_impl="cuda")
    batch = lm_batch(mj.cfg, 2, PROMPT, seed=11)
    want = jax.jit(jax_training.make_prefill_step(mj))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    pre = training.make_prefill_step(mt)(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(pre.shape) == (2, 1, mj.cfg.vocab_size)
    np.testing.assert_allclose(pre.numpy(), to_np(want), atol=ATOL, rtol=0)

    dec, cache = _decode_both(mj, pj, mt, pt, batch["tokens"], PROMPT + GEN)
    if arch in ("rwkv6-1.6b", "recurrentgemma-9b"):
        # The recurrences and the ring reproduce the prefill's last logits.
        np.testing.assert_allclose(dec.numpy(), pre.numpy(), atol=ATOL, rtol=0)
    if arch == "recurrentgemma-9b":
        ring = cache["layers"]["b2"]["kv"]["k"]
        assert ring.shape[-2] == mt.cfg.window < PROMPT + GEN
        assert bool((ring.abs().sum(-1) > 0).all())          # every slot written


def test_vlm_decode_cache_holds_no_patches():
    """A cache shorter than the prefix (serve.py's prompt + gen slots): every
    decode write at pos + prefix_tokens clamps to the last slot, the other
    slots stay zero and take part in the softmax, as in the reference."""
    mj, pj, mt, pt = _pair("paligemma-3b", jax_impl="reference", port_impl="cuda")
    prompt = lm_batch(mj.cfg, 2, 3, seed=12)["tokens"]
    slots = 3 + GEN - 5
    assert slots < mt.cfg.prefix_tokens
    _, cache = _decode_both(mj, pj, mt, pt, prompt, slots)
    k = cache["layers"]["b0"]["kv"]["k"]                     # (G, B, Hkv, S, Dh)
    assert float(k[..., :-1, :].abs().max()) == 0.0
    assert bool((k[..., -1, :].abs().sum(-1) > 0).all())


def test_whisper_decode_cross_attention_adds_zero():
    """``cross_kv`` starts at zero and stays there (the reference's
    ``init_cache`` ignores the encoder output it is given): the port's
    decode equals the reference's given ``enc_out``, and other cross
    weights leave the logits unchanged."""
    mj, pj, mt, pt = _pair("whisper-base", jax_impl="reference", port_impl="cuda")
    batch = lm_batch(mj.cfg, 2, 4, seed=13)
    enc_out = mj.encode(pj, jnp.asarray(batch["frames"]))
    logits, cache = _decode_both(mj, pj, mt, pt, batch["tokens"], 4 + GEN, enc_out)
    assert all(float(t.abs().max()) == 0.0
               for t in tree_leaves(cache["layers"]["b0"]["cross_kv"]))
    other = dict(pt, layers={"b0": dict(pt["layers"]["b0"], cross={
        k: torch.randn_like(v) for k, v in pt["layers"]["b0"]["cross"].items()})})
    cache = mt.init_cache(2, 4 + GEN, "cpu")
    for i in range(4):
        again, cache = mt.decode_step(other, cache, torch.from_numpy(batch["tokens"][:, i:i + 1]),
                                      i)
    np.testing.assert_array_equal(again.numpy(), logits.numpy())


@pytest.mark.parametrize("arch", FAMILIES + ["phi3.5-moe-42b-a6.6b"])
def test_bf16_forward_matches_jax(arch):
    """bf16 logits within a relative L2 of 2e-2 of the reference's."""
    mj, pj, mt, pt = _pair(arch, dtype="bfloat16", jax_impl="reference", port_impl="cuda")
    batch = lm_batch(mj.cfg, 2, 16, seed=14)
    want = to_np(mj.forward(pj, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    got = mt.forward(pt, {k: torch.from_numpy(v) for k, v in batch.items()})[0].numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                      "--gen", "4", "--seed", "2"])
    assert "serving OK" in capsys.readouterr().out
    assert out["generated"].shape == (2, 4) and out["config"] == reduced_config(arch)


def test_serve_defaults_to_rwkv6_as_the_reference(monkeypatch):
    from repro_torch.launch import serve

    seen = {}

    class Stop(Exception):
        pass

    def capture(cfg):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(serve, "build_model", capture)
    with pytest.raises(Stop):
        serve.main(["--device", "cpu"])
    assert seen["cfg"] == reduced_config("rwkv6-1.6b")
