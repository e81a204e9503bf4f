"""The port's rwkv6 and RG-LRU blocks (``repro_torch.models.rwkv6`` /
``rglru``) against the reference's on numpy inputs from a seed, f32.

Tolerances: ``atol=5e-5`` throughout (seen: 1.4e-6 for rwkv6 over 48 tokens,
4.8e-7 for the RG-LRU block over 33; products and exponentials in other
orders); the associative scan ``rtol=1e-6`` of JAX's (the same pairs in the
same order, XLA may fuse a multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro.models import rglru as jrg
from repro.models import rwkv6 as jrw
from repro.models.params import unzip
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv6 as trw

ATOL = 5e-5
H, DH = 2, 16
D = H * DH


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _rwkv_params(seed=0):
    """Reference weights with the decay terms randomised (the init's zeros
    would make every decay the same)."""
    rng = np.random.default_rng(seed)
    p = unzip(jrw.rwkv6_init(jax.random.PRNGKey(seed), D, H, DH, lora_rank=8))[0]
    p["w0"] = jnp.asarray(rng.normal(-0.5, 0.5, (D,)), jnp.float32)
    p["w_lora_b"] = jnp.asarray(rng.normal(0, 0.1, (8, D)), jnp.float32)
    p["u"] = jnp.asarray(rng.normal(0, 0.3, (H, DH)), jnp.float32)
    p["mu"] = jnp.asarray(rng.uniform(0, 1, (5, D)), jnp.float32)
    return p, _t(p)


def _x(b, t, d, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, t, d)).astype(np.float32)


@pytest.mark.parametrize("impl,t,chunk", [("sequential", 13, 8), ("chunked", 13, 8),
                                          ("chunked", 21, 8), ("chunked", 48, 16),
                                          ("chunked", 1, 8)])
def test_rwkv6_time_mix_matches_jax(impl, t, chunk):
    pj, pt = _rwkv_params()
    x = _x(2, t, D, t)
    want, (wx, ws) = jrw.rwkv6_time_mix(pj, jnp.asarray(x), H, DH, chunk=chunk, impl=impl,
                                        compute_dtype=jnp.float32)
    got, (gx, gs) = trw.rwkv6_time_mix(pt, torch.from_numpy(x), H, DH, chunk=chunk, impl=impl,
                                       compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gs.numpy(), to_np(ws), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(gx.numpy(), to_np(wx))


def test_rwkv6_chunked_equals_sequential_and_clamps_the_decay():
    pj, pt = _rwkv_params(seed=3)
    x = torch.from_numpy(_x(2, 29, D, 5) * 4)
    seq, (_, s_seq) = trw.rwkv6_time_mix(pt, x, H, DH, impl="sequential",
                                         compute_dtype=torch.float32)
    chk, (_, s_chk) = trw.rwkv6_time_mix(pt, x, H, DH, chunk=8, compute_dtype=torch.float32)
    np.testing.assert_allclose(chk.numpy(), seq.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_chk.numpy(), s_seq.numpy(), atol=ATOL, rtol=0)
    _, _, _, _, log_decay = trw._project(pt, x, torch.roll(x, 1, 1), torch.float32)
    assert float(log_decay.min()) == float(np.float32(-trw.DECAY_CLAMP))
    assert float(log_decay.max()) <= 0
    with pytest.raises(ValueError, match="rwkv6 impl"):
        trw.rwkv6_time_mix(pt, x, H, DH, impl="pallas")


def test_rwkv6_state_carries_across_two_calls():
    """[x1; x2] in one call equals x1 then x2 with the carried (prev_x, S),
    in the port and in the reference; the port's two calls equal the
    reference's two calls."""
    pj, pt = _rwkv_params(seed=1)
    x = _x(2, 24, D, 9)
    full, _ = trw.rwkv6_time_mix(pt, torch.from_numpy(x), H, DH, chunk=8,
                                 compute_dtype=torch.float32)
    o1, st = trw.rwkv6_time_mix(pt, torch.from_numpy(x[:, :11]), H, DH, chunk=8,
                                compute_dtype=torch.float32)
    o2, st2 = trw.rwkv6_time_mix(pt, torch.from_numpy(x[:, 11:]), H, DH, state=st, chunk=8,
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), full.numpy(), atol=ATOL, rtol=0)
    j1, jst = jrw.rwkv6_time_mix(pj, jnp.asarray(x[:, :11]), H, DH, chunk=8,
                                 compute_dtype=jnp.float32)
    j2, jst2 = jrw.rwkv6_time_mix(pj, jnp.asarray(x[:, 11:]), H, DH, state=jst, chunk=8,
                                  compute_dtype=jnp.float32)
    np.testing.assert_allclose(o2.numpy(), to_np(j2), atol=ATOL, rtol=0)
    np.testing.assert_allclose(st2[1].numpy(), to_np(jst2[1]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_matches_jax(with_state):
    rng = np.random.default_rng(4)
    pj = unzip(jrw.rwkv6_channel_init(jax.random.PRNGKey(4), D, 48))[0]
    pj["mu"] = jnp.asarray(rng.uniform(0, 1, (2, D)), jnp.float32)
    pj["wr"] = jnp.asarray(rng.normal(0, 0.2, (D, D)), jnp.float32)
    x = _x(3, 7, D, 2)
    prev = rng.normal(0, 1, (3, D)).astype(np.float32) if with_state else None
    want, wlast = jrw.rwkv6_channel_mix(pj, jnp.asarray(x), state=None if prev is None
                                        else jnp.asarray(prev), compute_dtype=jnp.float32)
    got, glast = trw.rwkv6_channel_mix(_t(pj), torch.from_numpy(x), state=None if prev is None
                                       else torch.from_numpy(prev), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(glast.numpy(), to_np(wlast))


def test_rwkv6_decode_step_matches_jax():
    """One token with a carried state: the sequential path at T = 1."""
    pj, pt = _rwkv_params(seed=2)
    rng = np.random.default_rng(6)
    x = _x(2, 1, D, 6)
    prev = rng.normal(0, 1, (2, D)).astype(np.float32)
    s = rng.normal(0, 0.5, (2, H, DH, DH)).astype(np.float32)
    want, (wx, ws) = jrw.rwkv6_decode_step(pj, jnp.asarray(x), (jnp.asarray(prev), jnp.asarray(s)),
                                           H, DH, compute_dtype=jnp.float32)
    got, (gx, gs) = trw.rwkv6_decode_step(pt, torch.from_numpy(x),
                                          (torch.from_numpy(prev), torch.from_numpy(s)), H, DH,
                                          compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gs.numpy(), to_np(ws), atol=ATOL, rtol=0)


# ----------------------------------------------------------------- RG-LRU

W = 48


def _rglru_params(seed=0):
    rng = np.random.default_rng(seed)
    p = unzip(jrg.rglru_init(jax.random.PRNGKey(seed), D, W, 4))[0]
    p["ba"] = jnp.asarray(rng.normal(0, 0.5, (W,)), jnp.float32)
    p["bx"] = jnp.asarray(rng.normal(0, 0.5, (W,)), jnp.float32)
    return p, _t(p)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 33])
def test_associative_scan_matches_jax(n):
    """The odd/even recursion of ``jax.lax.associative_scan`` over the
    RG-LRU's combine, at even and odd lengths."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    x = rng.normal(0, 1, (2, n, 5)).astype(np.float32)
    combine = lambda l, r: (l[0] * r[0], r[1] + r[0] * l[1])
    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(x)), axis=1)
    got = trg.associative_scan(trg._combine, [torch.from_numpy(a), torch.from_numpy(x)], dim=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), to_np(w), rtol=1e-6, atol=1e-7)
    h, seq = np.zeros((2, 5), np.float32), []
    for i in range(n):                                  # the recurrence, step by step
        h = a[:, i] * h + x[:, i]
        seq.append(h)
    np.testing.assert_allclose(got[1].numpy(), np.stack(seq, 1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,with_state", [(1, True), (7, False), (16, True), (33, True)])
def test_rglru_block_matches_jax(t, with_state):
    """The block with the conv tail and ``h0`` carried in (and at T = 1,
    the decode step)."""
    pj, pt = _rglru_params(seed=t)
    rng = np.random.default_rng(t)
    x = _x(2, t, D, t + 1)
    sj = st = None
    if with_state:
        h0 = rng.normal(0, 1, (2, W)).astype(np.float32)
        tail = rng.normal(0, 1, (2, 3, W)).astype(np.float32)
        sj = jrg.RGLRUState(jnp.asarray(h0), jnp.asarray(tail))
        st = trg.RGLRUState(torch.from_numpy(h0), torch.from_numpy(tail))
    want, wst = jrg.rglru_block_apply(pj, jnp.asarray(x), sj, compute_dtype=jnp.float32)
    got, gst = trg.rglru_block_apply(pt, torch.from_numpy(x), st, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gst.h.numpy(), to_np(wst.h), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gst.conv_tail.numpy(), to_np(wst.conv_tail), atol=ATOL, rtol=0)
    if t == 1:
        dec, dst = trg.rglru_decode_step(pt, torch.from_numpy(x), st,
                                         compute_dtype=torch.float32)
        np.testing.assert_array_equal(dec.numpy(), got.numpy())
        np.testing.assert_array_equal(dst.h.numpy(), gst.h.numpy())


def test_rglru_decode_steps_equal_the_block():
    """T tokens one decode step at a time, the state carried, equal the
    block over all T at once."""
    _, pt = _rglru_params(seed=5)
    x = torch.from_numpy(_x(2, 10, D, 5))
    full, fst = trg.rglru_block_apply(pt, x, compute_dtype=torch.float32)
    st = trg.rglru_init_state(2, W, 4, torch.float32)
    outs = []
    for i in range(10):
        o, st = trg.rglru_decode_step(pt, x[:, i:i + 1], st, compute_dtype=torch.float32)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(st.h.numpy(), fst.h.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(st.conv_tail.numpy(), fst.conv_tail.numpy(), atol=ATOL, rtol=0)
