"""ctypes wrapper of ``csrc/cell_rank.cu`` (replaces the Pallas
``cell_rank_tiled``; the design note is in the source).

:func:`cell_rank_cuda` takes CUDA tensors only; ``ops.cell_rank`` routes CPU
tensors to the plain tiled-histogram version.  ``launches`` counts the
wrapper's kernel launches (one per call, which enqueues the count, bucket
and rank passes).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("cell_rank")
    if not getattr(lib, "_typed", False):
        lib.cell_rank_count.argtypes = [_I, _P, _I, _I, _P, _P]
        lib.cell_rank_count.restype = _I
        lib.cell_rank_finish.argtypes = [_I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P]
        lib.cell_rank_finish.restype = _I
        lib._typed = True
    return lib


def cell_rank_cuda(cid: torch.Tensor, n_cells: int) -> torch.Tensor:
    """``rank[i] = #{j < i : cid[j] == cid[i]}`` for ``cid (C,) int32`` with
    values in ``[0, n_cells]`` (``n_cells`` is the dead-agent bin)."""
    global launches
    if cid.dtype != torch.int32 or cid.ndim != 1:
        raise ValueError(f"cell_rank: cid must be (C,) int32, got {cid.dtype} "
                         f"{tuple(cid.shape)}")
    _build.require_cuda("cell_rank", cid)
    n = cid.shape[0]
    dev = cid.device
    lib = _lib()
    stream = _build.stream_of(cid)
    counts = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return rank
    _build.check(
        lib.cell_rank_count(dev.index, _build.ptr(cid), n, n_cells,
                            _build.ptr(counts), stream),
        "cell_rank_count",
    )
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    cursor = offsets.clone()
    dead = (cid == n_cells).to(torch.int32)
    dead_prefix = torch.cumsum(dead, 0, dtype=torch.int32) - dead
    bucket = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.check(
        lib.cell_rank_finish(
            dev.index, _build.ptr(cid), n, n_cells, _build.ptr(offsets),
            _build.ptr(counts), _build.ptr(cursor), _build.ptr(bucket),
            _build.ptr(dead_prefix), _build.ptr(rank), stream,
        ),
        "cell_rank_finish",
    )
    launches += 1
    return rank
