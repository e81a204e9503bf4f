"""Space-filling-curve (Morton / Z-order) tables (§5.4.2).

A copy of the numpy half of ``repro.core.morton`` (the port imports nothing
of the reference): codes interleave three ≤10-bit coordinates into a 30-bit
key, and the per-grid-shape tables ``zorder_cells`` / ``cell_zrank`` are
computed once on the host and uploaded by the grid code, so the layout sort
needs no device sort.  :func:`encode3_torch` computes the same codes on
tensors for the argsort path past ``MAX_TABLE_CELLS``; :func:`decode3`
inverts either; :func:`bits_for` sizes a dimension's bit budget.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Largest grid (in cells) for which the Z-rank tables are materialized
# (4 MiB of int32 at the cap); beyond it sort_agents falls back to an argsort.
MAX_TABLE_CELLS = 1 << 20

_B32 = [0x09249249, 0x030C30C3, 0x0300F00F, 0xFF0000FF, 0x000003FF]
_S32 = [2, 4, 8, 16]


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint32) & np.uint32(_B32[4])
    x = (x | (x << _S32[3])) & np.uint32(_B32[3])
    x = (x | (x << _S32[2])) & np.uint32(_B32[2])
    x = (x | (x << _S32[1])) & np.uint32(_B32[1])
    x = (x | (x << _S32[0])) & np.uint32(_B32[0])
    return x


def encode3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray) -> np.ndarray:
    """Interleave three ≤10-bit integer coordinates into a 30-bit Morton code."""
    return _part1by2(ix) | (_part1by2(iy) << np.uint32(1)) | (
        _part1by2(iz) << np.uint32(2)
    )


# The reference's host-side mirror of its jnp ``encode3``; here ``encode3``
# is itself the numpy version.
encode3_np = encode3


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Gather every third bit of x (bits 0, 3, 6, ...) into its low 10 bits."""
    x = x & _B32[0]
    x = (x | (x >> _S32[0])) & _B32[1]
    x = (x | (x >> _S32[1])) & _B32[2]
    x = (x | (x >> _S32[2])) & _B32[3]
    x = (x | (x >> _S32[3])) & _B32[4]
    return x


def decode3(code) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three coordinates of 30-bit Morton codes (a tensor or a numpy
    array, as :func:`encode3_torch` / :func:`encode3` give them), as int64
    tensors on the codes' device."""
    code = (torch.from_numpy(code.astype(np.int64)) if isinstance(code, np.ndarray)
            else code.to(torch.int64)) & 0xFFFFFFFF
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def bits_for(n: int) -> int:
    """Number of bits needed to index ``n`` cells (non-cubic grid support)."""
    return max(int(n - 1).bit_length(), 1)


def _part1by2_torch(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & _B32[4]
    x = (x | (x << _S32[3])) & _B32[3]
    x = (x | (x << _S32[2])) & _B32[2]
    x = (x | (x << _S32[1])) & _B32[1]
    x = (x | (x << _S32[0])) & _B32[0]
    return x


def encode3_torch(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """:func:`encode3` on tensors; int64 codes (< 2³⁰)."""
    return (
        _part1by2_torch(ix)
        | (_part1by2_torch(iy) << 1)
        | (_part1by2_torch(iz) << 2)
    )


def max_grid_dim() -> int:
    """Largest per-dimension grid size encodable in a uint32 Morton code."""
    return 1 << 10


@functools.lru_cache(maxsize=None)
def zorder_cells(dims: tuple[int, int, int], use_morton: bool = True) -> np.ndarray:
    """Linear cell ids listed in layout order (Z-order when ``use_morton``).

    Entry ``r`` is the linear cell id occupying rank ``r`` of the layout
    sort key; with ``use_morton=False`` the layout key is the linear id.
    """
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    if not use_morton:
        return np.arange(n_cells, dtype=np.int32)
    ix, iy, iz = np.meshgrid(
        np.arange(nx, dtype=np.uint32),
        np.arange(ny, dtype=np.uint32),
        np.arange(nz, dtype=np.uint32),
        indexing="ij",
    )
    codes = encode3(ix, iy, iz).reshape(-1)
    return np.argsort(codes, kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=None)
def cell_zrank(dims: tuple[int, int, int], use_morton: bool = True) -> np.ndarray:
    """Inverse of :func:`zorder_cells`: linear cell id → rank in layout order."""
    order = zorder_cells(dims, use_morton)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    return inv
