"""The port's attention and RMSNorm gradients against the reference's on the
CPU.

* ``chunked_vjp.FlashAttention`` (the flash forward with its logsumexp and
  the blockwise FlashAttention backward) against ``jax.vjp`` of the
  reference's ``chunked_attention`` (``chunked_vjp.py``): the output, the
  logsumexp (the reference's ``_forward`` on the same blocking) and dq / dk
  / dv, in f32, over causal, window, prefix, GQA 3, ``kv_offset``, a ragged
  Tk and rows whose keys are all hidden.  Tolerance: ``atol=2e-5`` on
  outputs and gradients of unit-scale inputs (sums in other orders over
  D ≤ 32 and Tk ≤ 75; seen ≤ 2e-6), lse ``atol=2e-5``.
* The RMSNorm Function's ``dx`` and ``dscale`` against ``jax.grad`` of the
  reference's ``norm_apply``: f32 ``rtol=1e-5, atol=1e-6``; bf16 ``x`` one
  bf16 ulp of ``dx`` (``rtol=2**-7, atol=1e-6``), ``dscale`` (f32)
  ``rtol=1e-4``.
* The remat policies: ``remat=True`` ("full" and "dots") give the gradient
  of ``remat=False`` to f32 round-off (``atol=1e-6``; the same ops in the
  same order, recomputed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro.kernels.flash_attention import chunked_vjp as jax_vjp
from repro.kernels.flash_attention import ops as jax_fa
from repro.models import layers as jax_layers
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_leaves

ATOL = 2e-5
BLOCK = 16

# (B, Hq, Hkv, Tq, Tk, D), mask kwargs
CASES = {
    "causal": ((2, 2, 2, 40, 40, 16), dict(causal=True)),
    "window": ((1, 4, 2, 48, 48, 16), dict(causal=True, window=7)),
    "prefix": ((1, 2, 1, 37, 37, 32), dict(causal=True, prefix_len=11)),
    "gqa3": ((2, 6, 2, 33, 33, 16), dict(causal=True)),
    "kv_offset": ((1, 3, 1, 20, 52, 16), dict(causal=True, kv_offset=32)),
    "ragged_tk_full": ((1, 2, 2, 29, 75, 8), dict(causal=False)),
    # queries at 40.. over keys 0..29 with a window of 6: every row's keys
    # are hidden; in the next case (queries at 8.. over keys 0..23, window 3)
    # rows 0..15 see 3 keys, rows 16 and 17 see 2 and 1, rows 18..23 none.
    "all_hidden_rows": ((1, 2, 1, 10, 30, 8), dict(causal=True, window=6, kv_offset=40)),
    "some_hidden_rows": ((1, 3, 3, 24, 24, 8), dict(causal=True, window=3, kv_offset=8,
                                                     prefix_len=0)),
}


def _inputs(case, seed):
    (b, hq, hkv, tq, tk, d), kw = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, s).astype(np.float32)
                   for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d), (b, hq, tq, d)))
    return (q, k, v, do), kw


def _jax_lse(q, k, v, causal=True, window=None, prefix_len=0, kv_offset=0):
    """The reference's logsumexp: ``chunked_vjp._forward`` on the blocking
    ``chunked_attention`` uses, unblocked to (B, Hq, Tq)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    qp = jax_fa._pad_axis(jnp.asarray(q), 2, BLOCK)
    kp = jax_fa._pad_axis(jnp.asarray(k), 2, BLOCK)
    vp = jax_fa._pad_axis(jnp.asarray(v), 2, BLOCK)
    nq, nk = qp.shape[2] // BLOCK, kp.shape[2] // BLOCK
    qb = qp.reshape(b, hkv, group * nq, BLOCK, d)
    kb = kp.reshape(b, hkv, nk, BLOCK, d)
    vb = vp.reshape(b, hkv, nk, BLOCK, d)
    _, lse = jax_vjp._forward(qb, kb, vb, tk, causal, window, prefix_len, kv_offset,
                              BLOCK, BLOCK, d ** -0.5, False, nq)
    return to_np(lse.reshape(b, hq, nq * BLOCK)[:, :, :tq])


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_function_matches_jax_vjp(case):
    (q, k, v, do), kw = _inputs(case, sorted(CASES).index(case))
    f = lambda q_, k_, v_: jax_fa.chunked_attention(q_, k_, v_, block_q=BLOCK, block_k=BLOCK,
                                                    **kw)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    dq_w, dk_w, dv_w = vjp(jnp.asarray(do))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    counts = (fa_kernel.launches, fa_kernel.launches_tc)
    out = fa_ops.flash_attention(qt, kt, vt, impl="cuda", block_k=BLOCK, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    assert (fa_kernel.launches, fa_kernel.launches_tc) == counts       # CPU: plain version
    np.testing.assert_allclose(to_np(out), to_np(want), atol=ATOL, rtol=0)
    for name, got, ref in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)):
        assert got.shape == ref.shape and got.dtype == torch.float32, name
        np.testing.assert_allclose(to_np(got), to_np(ref), atol=ATOL, rtol=0, err_msg=name)

    _, lse = fa_ops.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                      block_k=BLOCK, return_lse=True, **kw)
    lse_w = _jax_lse(q, k, v, **kw)
    np.testing.assert_allclose(to_np(lse), lse_w, atol=ATOL, rtol=1e-6)
    if case == "all_hidden_rows":
        assert float(out.detach().abs().max()) == 0.0 and float(dq.abs().max()) == 0.0
        assert np.all(lse_w == -1e30) and np.all(to_np(lse) == -1e30)


def test_flash_function_chunked_and_block_sizes_agree():
    """``impl="chunked"`` runs the same Function; the backward's KV block
    changes only the sum order (atol 2e-6)."""
    (q, k, v, do), kw = _inputs("prefix", 1)
    grads = []
    for impl, block in (("cuda", 16), ("chunked", 16), ("chunked", 5)):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fa_ops.flash_attention(*ts, impl=impl, block_k=block, **kw)
        grads.append(torch.autograd.grad(out, ts, torch.from_numpy(do)))
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0], grads[2]):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=2e-6, rtol=0)


def test_flash_serving_path_records_nothing():
    """Without autograd recording the dispatcher calls the forward directly."""
    (q, k, v, _), kw = _inputs("causal", 0)
    with torch.no_grad():
        out = fa_ops.flash_attention(*(torch.from_numpy(a).requires_grad_() for a in (q, k, v)),
                                     impl="cuda", block_k=BLOCK, **kw)
    assert out.grad_fn is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grad_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (3, 5, 48)).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(0, 1, (48,))).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jd)
    yj, vjp = jax.vjp(lambda x_, s_: jax_layers.norm_apply({"scale": s_}, x_, "rmsnorm"),
                      xj, jnp.asarray(scale))
    dx_w, ds_w = vjp(jnp.asarray(dy, jd))

    xt = torch.from_numpy(to_np(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    xt.requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    count = rms_kernel.launches
    y = rms_ops.rmsnorm(xt, st, impl="cuda")
    assert "RMSNorm" in type(y.grad_fn).__name__
    dx, ds = torch.autograd.grad(y, (xt, st), torch.from_numpy(dy).to(xt.dtype))
    assert rms_kernel.launches == count and dx.dtype == xt.dtype and ds.dtype == torch.float32
    if dtype == "float32":
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(to_np(y), to_np(yj), **tol)
        np.testing.assert_allclose(to_np(dx), to_np(dx_w), **tol)
        np.testing.assert_allclose(to_np(ds), to_np(ds_w), rtol=1e-5, atol=1e-5)
    else:
        tol = dict(rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(to_np(y.float()), to_np(yj.astype(jnp.float32)), **tol)
        np.testing.assert_allclose(to_np(dx.float()), to_np(dx_w.astype(jnp.float32)), **tol)
        np.testing.assert_allclose(to_np(ds), to_np(ds_w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_gradient_without_it(policy):
    """Reduced phi4-mini (f32): ``remat=True`` runs each layer and loss
    chunk under ``torch.utils.checkpoint`` and recomputes their forward in
    the backward (the attention and RMSNorm Functions run twice); the loss
    and every gradient leaf equal those without remat to f32 round-off."""
    base = reduced_config("phi4-mini-3.8b")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 12)).astype(np.int32))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(base, remat=remat, remat_policy=policy,
                                                attention_impl="cuda"))
        params = model.init(0, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6, rtol=0)
