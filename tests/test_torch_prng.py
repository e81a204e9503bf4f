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
