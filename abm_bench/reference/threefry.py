"""Threefry-2x32 key derivation and uniform draws, as ``jax.random`` makes them.

A frozen copy of the arithmetic of ``src/repro_torch/core/prng.py`` (lines
40-135 there: ``threefry2x32``, ``PRNGKey``, ``fold_in``, ``split``,
``random_bits``, ``uniform``), kept here so that the benchmark's plain
reference works out every draw of a step from the seed and the state's key
without importing the program.  ``normal`` is written the plain way, with
``torch.erfinv``; the program evaluates XLA's erfinv polynomial instead, and
the two agree to a few dozen ulp, far inside the comparison's tolerances.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """20 rounds of Threefry-2x32 of ``(x0, x1)`` under ``key``; int64 tensors
    holding uint32 values."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _u64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & _MASK


def key_of(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor of uint32 words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k = _u64(key)
    d = torch.full((), int(data) & _MASK, dtype=torch.int64, device=key.device)
    return torch.stack(threefry2x32(k, torch.zeros_like(d), d), -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    k = _u64(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return torch.stack(threefry2x32(k[None], (i >> 32) & _MASK, i & _MASK), -1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(int(d) for d in shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(_u64(key), (i >> 32) & _MASK, i & _MASK)
    return (x0 ^ x1).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32 in ``[minval, maxval)``: 23 random mantissa bits under exponent 0."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal f32: ``sqrt(2) * erfinv(u)``, u uniform in (-1, 1)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    return math.sqrt(2.0) * torch.erfinv(uniform(key, shape, lo, 1.0))
