"""Threefry-2x32 keys, bit for bit as ``jax.random`` makes them.

JAX's default PRNG (impl ``threefry2x32``, ``jax_threefry_partitionable``
on, the default since jax 0.5) represents a key as two uint32 words.  This
module reproduces its key derivations so that the port folds and splits the
same keys as the reference:

  PRNGKey(seed)     = (seed >> 32, seed & 0xFFFFFFFF)   (0 high word for
                      seeds below 2³²)
  fold_in(key, d)   = threefry2x32(key, (0, d))
  split(key, n)[i]  = threefry2x32(key, (hi(i), lo(i)))  — the
                      partitionable split hashes a 64-bit iota

  random_bits(key, shape) = x0 ^ x1 of threefry2x32(key, (hi(i), lo(i)))
                      over the row-major iota i of ``shape``
  uniform(key, shape) = bitcast((bits >> 9) | 0x3F800000) − 1, scaled to
                      ``[minval, maxval)`` and floored at ``minval``
  normal(key, shape)  = √2 · erfinv(uniform(key, shape, nextafter(−1, 0), 1))

Keys are (2,) uint32 tensors (or (n, 2) for ``split``) on any device; the
hash runs in int64 arithmetic masked to 32 bits.  A *key batch* is a (B, 2)
tensor, one key a slot of a batch of sessions (``core/slots.py``):
``fold_in`` takes one datum or one a slot, ``split`` gives (num, B, 2), and
``random_bits`` / ``uniform`` / ``normal`` draw a ``shape`` whose leading
dimension is B·R as B blocks of R rows, block b drawn from key b exactly as
the solo draw of shape ``(R,) + shape[1:]``, so slot b of a batched draw is
the solo draw bit for bit.  ``random_bits`` and
``uniform`` are bit-exact; ``normal`` evaluates XLA's single-precision
``erfinv`` polynomial in the same order and agrees to 3 ulp over every
value ``uniform`` can give (the two ``log1p``s differ by up to 2 ulp).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block function (20 rounds) of ``(x0, x1)`` under
    ``key``; all int64 tensors holding uint32 values."""
    k0 = key[..., 0]
    k1 = key[..., 1]
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


def _as_u64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & _MASK


def _as_key(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return torch.stack([x0, x1], dim=-1).to(torch.uint32)


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` key data, (2,) uint32."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device).to(torch.uint32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``data`` a python int or a
    uint32/int32 tensor; a (B, 2) key batch takes one datum or (B,) of them,
    and a (2,) key with (B,) data gives a (B, 2) batch.  A non-negative
    int32 tensor folds to the bits of the same python int, so the compiled
    run (``core/runner.py``) folds the device step counter itself; an int is
    filled on the device, not copied from the host."""
    k = _as_u64(key)
    if torch.is_tensor(data):
        d = _as_u64(data.to(key.device))
    else:
        d = torch.full((), int(data), dtype=torch.int64, device=key.device) & _MASK
    zero = torch.zeros_like(d)
    return _as_key(*threefry2x32(k, zero, d))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` key data, (num, 2) uint32; a (B, 2)
    key batch gives (num, B, 2)."""
    k = _as_u64(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    i = i.reshape((num,) + (1,) * (key.ndim - 1))
    return _as_key(*threefry2x32(k[None], (i >> 32) & _MASK, i & _MASK))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit), as int64 holding uint32.
    A (B, 2) key batch draws ``shape[0] // B`` rows from each key."""
    shape = tuple(int(d) for d in shape)
    k = _as_u64(key)
    per = shape
    if key.ndim == 2:
        slots = key.shape[0]
        if shape[0] % slots:
            raise ValueError(f"random_bits: {shape[0]} rows do not split over "
                             f"{slots} keys")
        per = (shape[0] // slots,) + shape[1:]
        k = k[:, None, :]
    i = torch.arange(math.prod(per), dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(k, (i >> 32) & _MASK, i & _MASK)
    return (x0 ^ x1).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in f32, bit for
    bit: 23 random mantissa bits under exponent 0 give ``[1, 2)``, minus one,
    scaled, and floored at ``minval``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv32 (xla/hlo/builder/lib/math.cc, after Giles, "Approximating
# the erfinv function"): a degree-8 polynomial in w = −log1p(−x²), one set of
# coefficients for w < 5 (in w − 2.5) and one beyond (in √w − 3).
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                  1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                  2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv``, step by step in f32.
    (``torch.erfinv`` differs from it by up to 65 ulp.)"""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, _ERFINV_W_LT_5[i], _ERFINV_W_GE_5[i])
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32 (to 3 ulp; see :func:`erfinv`)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return math.sqrt(2.0) * erfinv(u)
