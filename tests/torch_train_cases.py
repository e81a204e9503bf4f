"""Shared cases of the training parity tests (tests/test_torch_train*.py):
one reduced config's loss, metrics and every gradient leaf through the
reference (``jax.value_and_grad`` of ``Model.loss``) and the port (autograd),
from one draw of the reference's weights carried across as numpy.

Tolerances: the loss and ``ce`` ``rtol=1e-6``, ``zloss`` and ``aux``
``rtol=1e-5`` (f32 sums in other orders over two layers of width 64; seen ≤
1.5e-7 relative), ``tokens`` exact; each gradient leaf within ``2e-5 ·
max|leaf|`` of the reference's (seen ≤ 3.9e-6, recurrentgemma's RG-LRU gates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import to_np

from repro.configs import reduced_config as jax_reduced_config
from repro.models.model import build_model as jax_build_model
from repro.models.params import unzip
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_leaves

GRAD_RTOL = 2e-5


def loss_batch(cfg, b=2, t=16, seed=1):
    """Random tokens and targets (the last three targets of row 0 masked,
    -1), and ``patches`` / ``frames`` of unit normals."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    batch["targets"][0, -3:] = -1
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(0, 1, (b, cfg.prefix_tokens, cfg.d_model)
                                      ).astype(np.float32)
    return batch


def _paths(tree, prefix=""):
    """``jax.tree_util.keystr`` paths of a nested dict's leaves, in its
    insertion order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}['{k}']")]
    return [prefix]


def check_loss_and_grads(arch, spy_moe=None):
    """Runs both packages' loss and gradient on ``arch`` at reduced size
    (f32; the reference's attention ``"chunked"``, the custom VJP the port
    carries; the port's ``"cuda"``, its plain versions on the CPU) and
    asserts the tolerances above."""
    cj = dataclasses.replace(jax_reduced_config(arch), attention_impl="chunked")
    ct = dataclasses.replace(reduced_config(arch), attention_impl="cuda")
    mj, mt = jax_build_model(cj), build_model(ct)
    pj = unzip(mj.init(jax.random.PRNGKey(1)))[0]
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    batch = loss_batch(cj)
    (loss_w, met_w), grads_w = jax.jit(jax.value_and_grad(
        lambda p: mj.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True))(pj)

    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = mt.loss(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss, met = loss.detach(), {k: v.detach() for k, v in met.items()}

    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-6)
    assert set(met) == set(met_w) == {"ce", "aux", "zloss", "tokens"}
    np.testing.assert_allclose(float(met["ce"]), float(met_w["ce"]), rtol=1e-6)
    for k in ("aux", "zloss"):
        np.testing.assert_allclose(float(met[k]), float(met_w[k]), rtol=1e-5, atol=1e-12)
    assert float(met["tokens"]) == float(met_w["tokens"]) == 29.0
    assert (float(met["aux"]) > 0) == cj.is_moe

    want = {jax.tree_util.keystr(p): to_np(g)
            for p, g in jax.tree_util.tree_flatten_with_path(grads_w)[0]}
    got = dict(zip(_paths(pt), grads))
    assert set(got) == set(want)
    for key, g_w in want.items():
        g = np.zeros_like(g_w) if got[key] is None else to_np(got[key])
        assert g.shape == g_w.shape, key
        np.testing.assert_allclose(g, g_w, atol=GRAD_RTOL * max(float(np.abs(g_w).max()), 1e-12),
                                   rtol=0, err_msg=key)
    return pt
