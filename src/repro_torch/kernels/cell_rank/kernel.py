"""ctypes wrapper of ``csrc/cell_rank.cu`` (replaces the Pallas
``cell_rank_tiled``; the design note is in the source).

:func:`cell_rank_cuda` takes CUDA tensors only; ``ops.cell_rank`` routes CPU
tensors to the plain tiled-histogram version.  A call allocates the output
and one scratch workspace and makes one ctypes call, which enqueues a memset
and three kernels (count; bucket placement and fill; rank) and nothing else,
so it can be captured in a CUDA graph.  ``launches`` counts those calls.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0

# The kernel's tiling (csrc/cell_rank.cu keeps the same constants; its
# launcher refuses a workspace smaller than cell_rank_workspace_bytes).
AGENT_TILE = 1024   # agents a tile of the count, fill and rank passes
ROW = 4             # agents a cell keeps in its table row
SMALL_CELL = 64     # a cell with more agents is ranked by whole blocks
CHUNK = 2048        # agents of a crowded cell one block sorts
_COUNTERS = 192    # six counters, 128 bytes apart

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("cell_rank")
    if not getattr(lib, "_typed", False):
        lib.cell_rank_launch.argtypes = [_I, _P, _I, _I, _P, _L, _P, _P]
        lib.cell_rank_launch.restype = _I
        lib.cell_rank_workspace_bytes.argtypes = [_I, _I]
        lib.cell_rank_workspace_bytes.restype = _L
        lib._typed = True
    return lib


def max_chunks(n: int) -> int:
    """Most crowded-cell chunks ``n`` agents can make: the sum over cells of
    more than ``SMALL_CELL`` agents of ceil(count / ``CHUNK``)."""
    return n // (SMALL_CELL + 1) + n // CHUNK + 1


def workspace_bytes(n: int, n_cells: int) -> int:
    """Bytes of scratch for ``n`` agents over ``n_cells`` cells, int32 arrays:
    counts, counters and the chunks' flags (zeroed by the launch); then,
    16-byte aligned, each cell's table row of ``ROW`` agents, bucket offsets,
    each tile's dead agents, the chunk queue, slots, buckets."""
    tiles_a = -(-n // AGENT_TILE)
    zeroed = 4 * (n_cells + _COUNTERS + max_chunks(n))
    return -(-zeroed // 16) * 16 + 4 * ((ROW + 1) * n_cells + tiles_a + 2 * max_chunks(n) + 2 * n)


def _check(cid: torch.Tensor, n_cells: int) -> None:
    if cid.dtype != torch.int32 or cid.ndim != 1:
        raise ValueError(f"cell_rank: cid must be (C,) int32, got {cid.dtype} "
                         f"{tuple(cid.shape)}")
    if not 0 <= n_cells < 2**31 - 1:
        raise ValueError(f"cell_rank: n_cells {n_cells} outside [0, 2**31 - 1)")


def cell_rank_meta(cid: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The kernel's output and scratch on meta tensors (the dry-run), after
    its checks: launches and counts nothing."""
    _check(cid, n_cells)
    n = cid.shape[0]
    if n:
        torch.empty((workspace_bytes(n, n_cells),), dtype=torch.uint8, device=cid.device)
    return torch.empty((n,), dtype=torch.int32, device=cid.device)


def cell_rank_cuda(cid: torch.Tensor, n_cells: int) -> torch.Tensor:
    """``rank[i] = #{j < i : cid[j] == cid[i]}`` for ``cid (C,) int32`` with
    values in ``[0, n_cells]`` (``n_cells`` is the dead-agent bin); an id
    outside that range gets -1."""
    global launches
    _check(cid, n_cells)
    _build.require_cuda("cell_rank", cid)
    n = cid.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=cid.device)
    if n == 0:
        return rank
    size = workspace_bytes(n, n_cells)
    work = torch.empty((size,), dtype=torch.uint8, device=cid.device)
    _build.check(
        _lib().cell_rank_launch(cid.device.index, _build.ptr(cid), n, n_cells,
                                _build.ptr(work), size, _build.ptr(rank),
                                _build.stream_of(cid)),
        "cell_rank",
    )
    launches += 1
    return rank
