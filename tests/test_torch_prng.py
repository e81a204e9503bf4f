"""Threefry keys of the port vs ``jax.random`` (jax's default threefry2x32,
partitionable): the uint32 bits must be identical."""

import jax
import numpy as np
import pytest

from repro_torch.core import prng
from torch_parity import to_np

SEEDS = [0, 1, 2, 42, 12345, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bits(seed):
    want = to_np(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(to_np(prng.PRNGKey(seed)), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bits(seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    for data in (0, 1, 7, 16, 255, 1000, 2**31 - 1):
        want = to_np(jax.random.key_data(jax.random.fold_in(jkey, data)))
        np.testing.assert_array_equal(to_np(prng.fold_in(tkey, data)), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bits(seed, num):
    want = to_np(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), num)))
    np.testing.assert_array_equal(to_np(prng.split(prng.PRNGKey(seed), num)), want)


def test_schedule_key_chain_matches():
    """The engine's per-step chain: fold the step, then split in a behavior."""
    jkey, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for step in range(5):
        jk = jax.random.fold_in(jkey, step)
        tk = prng.fold_in(tkey, step)
        for _ in range(3):
            j1, j2 = jax.random.split(jk)
            t1, t2 = prng.split(tk)
            np.testing.assert_array_equal(to_np(t2), to_np(jax.random.key_data(j2)))
            jk, tk = j1, t1
        np.testing.assert_array_equal(to_np(tk), to_np(jax.random.key_data(jk)))


# --------------------------------------------------------------- draws
# uniform: bit-exact (bits and floats).  normal: the port evaluates XLA's
# single-precision erfinv polynomial step by step; it stays within 3 ulp of
# jax.random.normal because torch's log1p differs from XLA:CPU's by up to
# 2 ulp (torch.erfinv itself differs by up to 65 ulp, so it is not used).

SHAPES = [(7,), (300, 3), (2, 5, 4)]
DRAW_SEEDS = [0, 5, 2**31 - 1]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", DRAW_SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_and_uniform_are_exact(seed, shape):
    jkey, tkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3), prng.fold_in(
        prng.PRNGKey(seed), 3)
    want = to_np(jax.random.bits(jkey, shape))
    got = to_np(prng.random_bits(tkey, shape)).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0)]:
        want = to_np(jax.random.uniform(jkey, shape, minval=lo, maxval=hi))
        got = to_np(prng.uniform(tkey, shape, lo, hi))
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", DRAW_SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_within_three_ulp(seed, shape):
    jkey, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = to_np(jax.random.normal(jkey, shape))
    got = to_np(prng.normal(tkey, shape))
    assert got.dtype == np.float32 and got.shape == shape
    assert _ulps(got, want).max() <= 3


def test_erfinv_within_three_ulp_over_every_uniform_value():
    """Every input ``normal`` can see: the 2²³ values of the uniform draw on
    [nextafter(−1, 0), 1)."""
    import jax.numpy as jnp
    import torch
    from jax import lax

    bits = np.arange(2**23, dtype=np.uint32) | np.uint32(0x3F800000)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, (bits.view(np.float32) - np.float32(1.0)) * (np.float32(1.0) - lo) + lo)
    want = to_np(np.float32(np.sqrt(2.0)) * lax.erf_inv(jnp.asarray(u)))
    got = to_np(np.sqrt(2.0) * prng.erfinv(torch.from_numpy(u)))
    assert _ulps(got, want).max() <= 3
