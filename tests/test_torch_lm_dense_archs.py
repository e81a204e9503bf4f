"""The three dense archs that serve at full width on the card (gemma-7b,
mistral-nemo-12b, command-r-35b) through the port's serving entry points
against the reference on the CPU, in f32.

The plain ``reduced_config`` loses two of their shapes: it caps the KV
heads at 4 and sets 4 heads of 16 over a ``d_model`` of 64, so command-r's
group 8 becomes group 1 and ``n_heads · head_dim`` equals ``d_model``
again.  Both packages' configs here take the same overrides, which keep
each arch's group (16 / 16 → 8 / 8, 32 / 8 → 8 / 2, 64 / 8 → 8 / 1) and 8
heads of 16 over a ``d_model`` of 96.  The reference runs its O(T²)
oracle attention, the port its flash path (the plain version on CPU
tensors).  ``make_prefill_step`` on a 2 × 24 prompt, then the prompt and 8
greedy ``decode_step``s: logits ``atol=5e-5``, tokens equal (the tolerance
of ``tests/test_torch_lm.py``); the port's decode of the prompt agrees with
its own prefill within the same tolerance, the check ``chip_smoke.py``
makes at full width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import ATOL, _pair, lm_batch
from test_torch_lm_families import GEN, _decode_both
from torch_parity import to_np

from repro import training as jax_training
from repro.configs import reduced_config as jax_reduced_config
from repro_torch import training
from repro_torch.configs import get_config, reduced_config

PROMPT = 24
D_MODEL, HEADS, HEAD_DIM = 96, 8, 16
# arch -> reduced KV heads: the published group n_heads / n_kv_heads at 8 heads.
KV_HEADS = {"gemma-7b": 8, "mistral-nemo-12b": 2, "command-r-35b": 1}


def _overrides(arch):
    return dict(d_model=D_MODEL, n_heads=HEADS, n_kv_heads=KV_HEADS[arch], head_dim=HEAD_DIM)


@pytest.mark.parametrize("arch", sorted(KV_HEADS))
def test_reduced_configs_keep_the_group_and_the_head_width(arch):
    full, cfg = get_config(arch), reduced_config(arch, **_overrides(arch))
    assert cfg.n_heads // cfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert cfg.n_heads * cfg.head_dim != cfg.d_model
    assert (cfg.norm, cfg.activation, cfg.tie_embeddings) == (full.norm, full.activation,
                                                              full.tie_embeddings)
    ref = jax_reduced_config(arch, **_overrides(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", sorted(KV_HEADS))
def test_prefill_and_decode_match_jax(arch):
    mj, pj, mt, pt = _pair(arch, jax_impl="reference", port_impl="cuda", **_overrides(arch))
    batch = lm_batch(mj.cfg, 2, PROMPT, seed=21)
    want = jax.jit(jax_training.make_prefill_step(mj))(pj,
                                                       {"tokens": jnp.asarray(batch["tokens"])})
    pre = training.make_prefill_step(mt)(pt, {"tokens": torch.from_numpy(batch["tokens"])})
    assert tuple(pre.shape) == (2, 1, mj.cfg.vocab_size)
    np.testing.assert_allclose(pre.numpy(), to_np(want), atol=ATOL, rtol=0)

    dec, cache = _decode_both(mj, pj, mt, pt, batch["tokens"], PROMPT + GEN)
    np.testing.assert_allclose(dec.numpy(), pre.numpy(), atol=ATOL, rtol=0)
    k = cache["layers"]["b0"]["kv"]["k"]                     # (G, B, Hkv, S, Dh)
    assert tuple(k.shape[2:]) == (KV_HEADS[arch], PROMPT + GEN, HEAD_DIM)
