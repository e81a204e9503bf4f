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

Keys are (2,) uint32 tensors (or (n, 2) for ``split``) on any device; the
hash runs in int64 arithmetic masked to 32 bits.  ``uniform`` / ``normal``
come with the stochastic behaviours in the next slice of the port.
"""

from __future__ import annotations

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
    uint32/int32 scalar tensor."""
    k = _as_u64(key)
    d = _as_u64(torch.as_tensor(data, device=key.device))
    zero = torch.zeros_like(d)
    return _as_key(*threefry2x32(k, zero, d))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` key data, (num, 2) uint32."""
    k = _as_u64(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _as_key(*threefry2x32(k[None], (i >> 32) & _MASK, i & _MASK))
