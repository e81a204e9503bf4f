"""Uniform-grid environment: fixed-radius neighbor search (§5.3.1).

Port of ``repro.core.grid``.  The build is rank + scatter, no sort: each
agent's rank within its cell comes from ``kernels/cell_rank`` and the agent
id is scattered into a dense ``(n_cells, max_per_cell)`` cell list.  The
§5.4.2 layout sort (:func:`sort_agents`) is a counting sort over Z-ordered
cells built from the same primitive.  Neighbor queries gather the 27-box
stencil.

Nothing here reads the device or copies a host value to it once its
constants exist: the grid's origin and dims, the Z-order tables and the
27-box offsets are made once per (device, grid) by :func:`device_constant`
and kept, and the per-cell counts are a scatter-add (``torch.bincount``
reads the largest id back to size its output).  So a step's grid build and
layout sort can be captured in a CUDA graph (``core/runner.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import morton
from .agents import AgentPool, permute, permute_to
from .slots import row_slot

RANK_IMPLS = ("tiled", "cuda", "reference")

# Constant tensors by (name, parameters, device); see device_constant.
_CONSTANTS: dict = {}


def device_constant(key: tuple, device: torch.device, make) -> torch.Tensor:
    """The constant ``make()`` (a CPU tensor) on ``device``, made and copied
    there at its first use and kept for later ones.  A host-to-device copy
    synchronises, and under a CUDA graph capture it fails: every constant a
    captured step needs is made by the eager step that precedes its capture.
    On the card the host waits for the copy, so the constant is complete
    for every stream that reads it later: the distributed step's lanes
    (``core/lanes.py``) share a device's constants, whichever lane made
    them.  Callers must not write to the tensor."""
    device = torch.device(device)
    k = key + (device,)
    t = _CONSTANTS.get(k)
    if t is None:
        t = make().to(device)
        if t.is_cuda:
            torch.cuda.current_stream(device).synchronize()
        _CONSTANTS[k] = t
    return t


def bool_mask(values, device: torch.device) -> torch.Tensor:
    """``values`` (bools, one a session) as a kept (B,) bool tensor on
    ``device``: a :func:`device_constant` keyed by the tuple, so a captured
    step reads the mask its eager warm-up made."""
    values = tuple(bool(v) for v in values)
    return device_constant(("bools", values), device,
                           lambda: torch.tensor(values, dtype=torch.bool))


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int32: how many of ``ids`` (values in ``[0, n)``) equal each
    value; ``torch.bincount`` without its device reads."""
    counts = torch.zeros((n,), dtype=torch.int32, device=ids.device)
    return counts.index_add_(0, ids.long(), torch.ones_like(ids, dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of the uniform grid.

    ``rank_impl`` selects the within-cell ranking of the build and the
    layout sort: ``"tiled"`` (plain PyTorch tiled histogram, the
    reference's ``"xla"``), ``"cuda"`` (the hand-written kernel) or
    ``"reference"`` (the O(C²) oracle).
    """

    origin: Tuple[float, float, float]
    box_size: float
    dims: Tuple[int, int, int]
    max_per_cell: int
    use_morton: bool = True
    rank_impl: str = "tiled"

    def __post_init__(self):
        if self.rank_impl not in RANK_IMPLS:
            raise ValueError(
                f"unknown rank_impl {self.rank_impl!r}; expected {RANK_IMPLS}"
            )

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


@dataclasses.dataclass(frozen=True)
class GridIndex:
    """Built neighbor index over one agent pool.

    cell_of_agent: (C,)  int32 — linear cell id per agent (dead → n_cells).
    cell_list:     (n_cells, M) int32 — agent index per slot, C where empty;
                   slots ``0..min(count, M)-1`` of a row are filled, in
                   agent-index order.
    cell_count:    (n_cells,) int32 — #agents per cell (may exceed M).
    overflowed:    () bool — any cell exceeded max_per_cell.

    Over the flat view of B sessions of C rows (``core/slots.py``) each
    session has its own grid: ``cell_of_agent`` (B·C,) within-session cell
    ids, ``cell_list`` (B, n_cells, M) of within-session agent ids (C where
    empty), ``cell_count`` (B, n_cells), ``overflowed`` (B,).
    """

    cell_of_agent: torch.Tensor
    cell_list: torch.Tensor
    cell_count: torch.Tensor
    overflowed: torch.Tensor

    @property
    def slots(self) -> int | None:
        """B for the index of a batch's flat view, None solo."""
        return self.cell_list.shape[0] if self.cell_list.ndim == 3 else None


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` in f32 with true division.  A python-scalar divisor would
    let CUDA multiply by its reciprocal instead, which can move a value
    across a cell or voxel boundary."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def cell_coords(spec: GridSpec, position: torch.Tensor) -> torch.Tensor:
    """(N,3) float positions → (N,3) int32 cell coordinates, clipped to grid."""
    dev = position.device
    origin = device_constant(("origin", spec.origin), dev,
                             lambda: torch.tensor(spec.origin, dtype=torch.float32))
    rel = fdiv(position - origin, spec.box_size)
    ijk = torch.floor(rel).to(torch.int32)
    return torch.minimum(torch.clamp(ijk, min=0), grid_dims(spec, dev) - 1)


def grid_dims(spec: GridSpec, device: torch.device) -> torch.Tensor:
    """(3,) int32 ``spec.dims`` on ``device`` (a kept constant)."""
    return device_constant(("dims", spec.dims), device,
                           lambda: torch.tensor(spec.dims, dtype=torch.int32))


def linear_cell_id(spec: GridSpec, ijk: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = spec.dims
    return (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]


def sort_key(spec: GridSpec, ijk: torch.Tensor) -> torch.Tensor:
    """Sort key per agent (int64): Morton code or row-major linear id."""
    if spec.use_morton:
        return morton.encode3_torch(ijk[..., 0], ijk[..., 1], ijk[..., 2])
    return linear_cell_id(spec, ijk).to(torch.int64)


def layout_rank_table(spec: GridSpec, device: torch.device) -> torch.Tensor:
    """(n_cells + 1,) int32: linear cell id → rank in layout (Z-)order; slot
    ``n_cells`` is the dead-agent bin and ranks last (a kept constant)."""

    def make():
        table = torch.empty((spec.n_cells + 1,), dtype=torch.int32)
        table[:-1] = torch.from_numpy(morton.cell_zrank(spec.dims, spec.use_morton))
        table[-1] = spec.n_cells
        return table

    return device_constant(("zrank", spec.dims, spec.use_morton), device, make)


def _live_cell_ids(spec: GridSpec, position: torch.Tensor, alive: torch.Tensor):
    cid = linear_cell_id(spec, cell_coords(spec, position))
    return torch.where(alive, cid, spec.n_cells).to(torch.int32)


def _slot_keys(ids: torch.Tensor, slots: int | None, per_slot: int) -> torch.Tensor:
    """Ids of a batch's flat view made distinct across sessions: row r's id
    plus ``slot(r) · per_slot``.  Offset after ``cell_coords`` has clamped
    them, so no agent (a NaN one included) reaches another session's cells."""
    if slots is None:
        return ids
    return ids + (row_slot(ids.shape[0], slots, ids.device) * per_slot).to(ids.dtype)


def sort_agents(spec: GridSpec, pool: AgentPool, rank_tile: int | None = None
                ) -> AgentPool:
    """§5.4.2 agent sorting: reorder the pool along the space-filling curve,
    dead agents to the back.

    Counting sort: ``dest[i] = z_offset[cell[i]] + rank_within_cell[i]`` —
    exactly the slot a stable argsort on the Morton key gives agent ``i``.
    Grids past ``MAX_TABLE_CELLS`` use that stable argsort directly.  A
    batch's flat view sorts each session within its own rows, in one rank
    over ids offset per session (each with its own dead bin).
    """
    from repro_torch.kernels.cell_rank import ops as cr_ops

    slots = pool.slots
    rows = pool.capacity
    if spec.n_cells > morton.MAX_TABLE_CELLS:
        key = sort_key(spec, cell_coords(spec, pool.position))
        key = _slot_keys(torch.where(pool.alive, key, 0xFFFFFFFF), slots, 1 << 32)
        perm = torch.sort(key, stable=True).indices
        return permute(pool, perm)

    n_cells = spec.n_cells
    b = slots or 1
    cid = _live_cell_ids(spec, pool.position, pool.alive)
    zid = _slot_keys(layout_rank_table(spec, pool.device)[cid.long()], slots, n_cells + 1)
    rank = cr_ops.cell_rank(zid, n_cells=b * (n_cells + 1) - 1, impl=spec.rank_impl,
                            tile=rank_tile)
    counts = count_ids(zid, b * (n_cells + 1)).reshape(b, n_cells + 1)
    offsets = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    dest = offsets.reshape(-1)[zid.long()] + rank
    dest = _slot_keys(dest, slots, rows // b)
    return permute_to(pool, dest)


def cell_starts_sorted(spec: GridSpec, cell_count: torch.Tensor):
    """Per-cell ``[start, end)`` row ranges of a layout-sorted pool (within
    each session for a ``(B, n_cells)`` count)."""
    order = device_constant(
        ("zorder", spec.dims, spec.use_morton), cell_count.device,
        lambda: torch.from_numpy(morton.zorder_cells(spec.dims, spec.use_morton)).long())
    zcounts = cell_count[..., order]
    zstarts = torch.cumsum(zcounts, -1, dtype=torch.int32) - zcounts
    start = torch.zeros_like(cell_count)
    start[..., order] = zstarts
    return start, start + cell_count


def build_index_arrays(
    spec: GridSpec,
    position: torch.Tensor,
    alive: torch.Tensor,
    rank_tile: int | None = None,
    assume_sorted: bool = False,
    slots: int | None = None,
) -> GridIndex:
    """Build the cell list (the §5.3.1 build stage): cell id per agent, rank
    within its cell (``kernels/cell_rank``, or ``row − cell_start`` when
    ``assume_sorted`` promises a layout-sorted pool), scatter into
    ``cell_list[cell, rank]``.  ``slots``: the positions are the flat view of
    that many sessions; each gets its own grid, from one rank over ids
    offset per session."""
    from repro_torch.kernels.cell_rank import ops as cr_ops

    rows = position.shape[0]
    dev = position.device
    n_cells = spec.n_cells
    b = slots or 1
    c = rows // b
    cid = _live_cell_ids(spec, position, alive)
    key = _slot_keys(cid, slots, n_cells + 1)

    counts = count_ids(key, b * (n_cells + 1))
    cell_count = counts.reshape(b, n_cells + 1)[:, :n_cells]

    local = torch.arange(rows, dtype=torch.int32, device=dev)
    if slots is not None:
        local = local % c
    if assume_sorted:
        start, _ = cell_starts_sorted(spec, cell_count)
        start_ext = torch.cat([start, torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1)
        rank = local - start_ext.reshape(-1)[key.long()]
    else:
        rank = cr_ops.cell_rank(key, n_cells=b * (n_cells + 1) - 1, impl=spec.rank_impl,
                                tile=rank_tile)
    overflowed = (cell_count > spec.max_per_cell).any(dim=1)

    # Scatter into the dense cell list; overflow and dead agents all write
    # the spare last slot, which is cut off.
    m = spec.max_per_cell
    valid = alive & (rank < m)
    cell = _slot_keys(cid, slots, n_cells).long()
    flat_idx = torch.where(valid, cell * m + rank, b * n_cells * m)
    cell_list = torch.full((b * n_cells * m + 1,), c, dtype=torch.int32, device=dev)
    cell_list[flat_idx.long()] = local
    cell_list = cell_list[: b * n_cells * m].reshape(b, n_cells, m)

    if slots is None:
        cell_list, cell_count, overflowed = cell_list[0], cell_count[0], overflowed[0]
    return GridIndex(
        cell_of_agent=cid,
        cell_list=cell_list,
        cell_count=cell_count,
        overflowed=overflowed,
    )


def build_index(spec: GridSpec, pool: AgentPool, rank_tile: int | None = None,
                assume_sorted: bool = False) -> GridIndex:
    return build_index_arrays(spec, pool.position, pool.alive,
                              rank_tile=rank_tile, assume_sorted=assume_sorted,
                              slots=pool.slots)


NEIGHBOR_OFFSETS = torch.tensor(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=torch.int32,
)  # (27, 3)


def neighbor_offsets(device: torch.device) -> torch.Tensor:
    """``NEIGHBOR_OFFSETS`` on ``device`` (a kept constant)."""
    return device_constant(("neighbor_offsets",), device, NEIGHBOR_OFFSETS.clone)


def neighbor_cell_ids(spec: GridSpec, position: torch.Tensor):
    """27-box stencil cells per query: ``(nbr_cid, in_range)``, both (N, 27);
    ids are clipped into the grid — consult ``in_range`` before trusting one."""
    dev = position.device
    dims = grid_dims(spec, dev)
    nbr = cell_coords(spec, position)[:, None, :] + neighbor_offsets(dev)[None]
    in_range = ((nbr >= 0) & (nbr < dims)).all(dim=-1)
    nbr_cid = linear_cell_id(spec, torch.minimum(torch.clamp(nbr, min=0), dims - 1))
    return nbr_cid, in_range


def candidate_neighbors_arrays(
    spec: GridSpec,
    index: GridIndex,
    query_position: torch.Tensor,
    query_alive: torch.Tensor,
    query_ids: torch.Tensor | None = None,
):
    """Candidate neighbor ids per query (27-box stencil): ``(cand, mask)``,
    ``cand (N, 27·M) int32`` into the indexed set (indexed capacity where
    empty), ``mask (N, 27·M) bool`` (valid ∧ ¬self ∧ query alive).  Over a
    batch's index the ids are rows of the flat view: a query (its session
    told by its id, default its row) reads its own session's cells."""
    n = query_position.shape[0]
    m = spec.max_per_cell
    nbr_cid, in_range = neighbor_cell_ids(spec, query_position)
    sentinel = index.cell_of_agent.shape[0]
    if query_ids is None:
        query_ids = torch.arange(n, dtype=torch.int32, device=query_position.device)
    b = index.slots or 1
    c = sentinel // b
    if b > 1:
        base = (query_ids.long() // c)[:, None]
        nbr_cid = nbr_cid + base * spec.n_cells
    cand = index.cell_list.reshape(-1, m)[nbr_cid.long()]        # (N, 27, M)
    valid = in_range[:, :, None] & (cand < c)
    if b > 1:
        cand = cand + (base[:, :, None] * c).to(torch.int32)
    cand = torch.where(valid, cand, sentinel).reshape(n, 27 * m)
    valid = valid.reshape(n, 27 * m)
    mask = valid & (cand != query_ids[:, None]) & query_alive[:, None]
    return cand, mask


def candidate_neighbors(spec: GridSpec, index: GridIndex, pool: AgentPool):
    """Candidate neighbors of every agent in the pool (mask: valid ∧ ¬self)."""
    return candidate_neighbors_arrays(spec, index, pool.position, pool.alive)


def spec_for_space(
    min_bound: float,
    max_bound: float,
    interaction_radius: float,
    max_per_cell: int = 16,
    use_morton: bool = True,
    rank_impl: str = "tiled",
) -> GridSpec:
    """Cubic simulation space with box size ≥ the interaction radius."""
    extent = float(max_bound - min_bound)
    n = max(int(extent / interaction_radius), 1)
    n = min(n, morton.max_grid_dim())
    box = extent / n
    return GridSpec(
        origin=(min_bound, min_bound, min_bound),
        box_size=box,
        dims=(n, n, n),
        max_per_cell=max_per_cell,
        use_morton=use_morton,
        rank_impl=rank_impl,
    )
