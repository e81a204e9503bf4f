"""Dispatch for the sort-free within-cell rank primitive (§5.3.1).

``cell_rank`` computes, per agent, its rank among same-cell agents of lower
index — what the grid build scatters into ``cell_list[cell, rank]`` and
what the layout sort adds to its cell's offset.

  impl="tiled"      plain PyTorch tiled histogram (per-tile per-cell counts
                    → exclusive scan over tiles → intra-tile ranks); the
                    reference's ``"xla"`` impl and the default.
  impl="cuda"       the hand-written kernel (kernel.py, csrc/cell_rank.cu);
                    on CPU tensors it runs the ``"tiled"`` plain version.
  impl="reference"  O(C²) dense oracle (ref.py) — validation only.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import cell_rank_ref

IMPLS = ("tiled", "cuda", "reference")


def _default_tile(c: int, n_cells: int) -> int:
    """L ≈ √(n_cells+1), power of two, clamped to [32, 1024] and to the
    smallest power of two covering the population."""
    l = 1
    while l * l < n_cells + 1:
        l <<= 1
    cap = 32
    while cap < c and cap < 1024:
        cap <<= 1
    return max(32, min(l, cap, 1024))


def _rank_tiled(cid_tiles: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Tiled-histogram ranks over ``(T, L)`` tiled cell ids."""
    t, l = cid_tiles.shape
    dev = cid_tiles.device
    idx = cid_tiles.long()
    hist = torch.zeros((t, n_cells + 1), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, idx, torch.ones_like(cid_tiles))
    offs = torch.cumsum(hist, 0, dtype=torch.int32) - hist   # exclusive over tiles
    tile_off = torch.gather(offs, 1, idx)
    ar = torch.arange(l, device=dev)
    earlier = ar[:, None] > ar[None, :]
    same = cid_tiles[:, :, None] == cid_tiles[:, None, :]
    intra = (same & earlier[None]).sum(dim=2, dtype=torch.int32)
    return tile_off + intra


def cell_rank_tiled(cid: torch.Tensor, n_cells: int, tile: int | None = None
                    ) -> torch.Tensor:
    """The plain tiled-histogram version on any device."""
    c = cid.shape[0]
    l = int(tile) if tile else _default_tile(c, n_cells)
    t = -(-c // l)
    pad = t * l - c
    if pad:
        cid = torch.cat(
            [cid, torch.full((pad,), n_cells, dtype=torch.int32, device=cid.device)]
        )
    return _rank_tiled(cid.reshape(t, l), n_cells).reshape(-1)[:c]


def cell_rank(
    cid: torch.Tensor,
    n_cells: int,
    impl: str = "tiled",
    tile: int | None = None,
) -> torch.Tensor:
    """``rank[i] = |{j < i : cid[j] == cid[i]}|``, (C,) int32.

    ``cid`` holds values in ``[0, n_cells]`` (``n_cells`` itself is the
    dead-agent bin; its rows rank among themselves).  ``tile`` overrides the
    ≈√NC tile length of the ``"tiled"`` version.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown cell_rank impl {impl!r}; expected {IMPLS}")
    cid = cid.to(torch.int32).contiguous()
    if impl == "reference":
        return cell_rank_ref(cid)
    if impl == "cuda" and cid.device.type == "meta":
        return _kernel.cell_rank_meta(cid, n_cells)
    if impl == "cuda" and cid.device.type != "cpu":
        return _kernel.cell_rank_cuda(cid, n_cells)
    return cell_rank_tiled(cid, n_cells, tile)
