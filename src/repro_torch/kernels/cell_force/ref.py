"""Plain PyTorch versions of the two cell-force kernels (Eq 4.1).

``cell_list_force_ref`` is the port of ``repro/kernels/cell_force/ref.py``:
slot-centric like the kernel —
the queries are the agents listed in the cell list — but computed the
obvious way, materializing each query cell's 27-box candidate slots and
summing pair forces.  ``cells=(lo, hi)`` evaluates only query cells
``lo..hi-1`` (agents listed elsewhere get zero), so the dense
``(cells, M, 27·M)`` pair tensors can be built in pieces at full size.
``cell_window_force_ref`` is the Morton-window sweep of the Pallas
``_window_force_kernel``, one query tile at a time (``window_sweep_mask``
gives a tile's pair mask).  ``window_walk`` lists the rows that
``csrc/cell_window_force.cu`` walks instead, and ``window_walk_pairs`` the
pairs it keeps: the same pairs as the sweep's, for any row order.
"""

from __future__ import annotations

import torch

_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]


def cell_list_force_ref(
    position: torch.Tensor,   # (S, 3) f32
    radius: torch.Tensor,     # (S,) f32
    cell_list: torch.Tensor,  # (n_cells, M) int32, empty slots = S
    dims: tuple,              # (nx, ny, nz)
    k: float = 2.0,
    gamma: float = 1.0,
    num_out: int | None = None,
    cells: tuple[int, int] | None = None,
) -> torch.Tensor:
    nx, ny, nz = dims
    n_cells, m = cell_list.shape
    c = position.shape[0]
    dev = position.device
    out_n = c if num_out is None else int(num_out)
    lo, hi = (0, n_cells) if cells is None else (int(cells[0]), int(cells[1]))
    # Slot columns past the last one occupied in any row hold only the
    # sentinel and contribute nothing: drop them (exact; one host sync).
    occupied = (cell_list < c).any(dim=0).nonzero()
    m = int(occupied.max()) + 1 if occupied.numel() else 1
    cell_list = cell_list[:, :m]

    ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    cz = ids % nz
    cy = (ids // nz) % ny
    cx = ids // (nz * ny)

    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)   # (27, 3)
    nbx = cx[:, None] + offs[None, :, 0]
    nby = cy[:, None] + offs[None, :, 1]
    nbz = cz[:, None] + offs[None, :, 2]
    in_range = (
        (nbx >= 0) & (nbx < nx) & (nby >= 0) & (nby < ny) & (nbz >= 0) & (nbz < nz)
    )                                                              # (Q, 27)
    nb_cid = torch.clamp((nbx * ny + nby) * nz + nbz, 0, n_cells - 1)
    cand = cell_list[nb_cid.long()]                                # (Q, 27, M)
    cand_valid = (in_range[:, :, None] & (cand < c)).reshape(hi - lo, 27 * m)
    cand = cand.reshape(hi - lo, 27 * m)

    q_ids = cell_list[lo:hi]                                       # (Q, M)
    q_valid = q_ids < c
    q_safe = torch.where(q_valid, q_ids, 0).long()
    q_pos = position[q_safe]                                       # (Q, M, 3)
    q_rad = radius[q_safe]

    c_safe = torch.where(cand_valid, cand, 0).long()
    c_pos = position[c_safe]                                       # (Q, 27M, 3)
    c_rad = radius[c_safe]

    pair_ok = (
        q_valid[:, :, None]
        & cand_valid[:, None, :]
        & (q_ids[:, :, None] != cand[:, None, :])                  # exclude self
    )                                                              # (Q, M, 27M)
    dxc = q_pos[:, :, None, 0] - c_pos[:, None, :, 0]
    dyc = q_pos[:, :, None, 1] - c_pos[:, None, :, 1]
    dzc = q_pos[:, :, None, 2] - c_pos[:, None, :, 2]
    dist = torch.sqrt(dxc * dxc + dyc * dyc + dzc * dzc + 1e-20)
    qr = q_rad[:, :, None]
    cr = c_rad[:, None, :]
    delta = qr + cr - dist
    overlap = (delta > 0.0) & pair_ok
    rbar = qr * cr / torch.clamp(qr + cr, min=1e-20)
    mag = k * delta - gamma * torch.sqrt(torch.clamp(rbar * delta, min=0.0))
    scale = torch.where(overlap, mag / dist, 0.0)
    # Each pair's f32 force, summed in f64 and rounded once: the sum then
    # does not depend on how many slot columns the trimming kept (a source
    # set with more rows, such as the distributed engine's ghost-extended
    # one, keeps more), which a vectorized f32 sum's order does.  A pair
    # adds only where it overlaps, as in the kernel: a sentinel slot reads
    # row 0 and a non-finite row's offset is NaN, and 0 · NaN is NaN.
    slot_force = torch.stack(
        [torch.where(overlap, scale * d, 0.0).to(torch.float64).sum(2)
         for d in (dxc, dyc, dzc)], dim=-1
    ).to(torch.float32)                                            # (Q, M, 3)

    # Sentinel S and rows ≥ num_out drop: they land in a spare row, cut off.
    slots = q_ids.reshape(-1).long()
    slots = torch.where(slots < out_n, slots, out_n)
    out = torch.zeros((out_n + 1, 3), dtype=torch.float32, device=dev)
    out.index_put_((slots,), slot_force.reshape(-1, 3), accumulate=True)
    return out[:out_n]


def _cell_coords(cid: torch.Tensor, dims: tuple) -> torch.Tensor:
    _, ny, nz = dims
    return torch.stack([cid // (ny * nz), (cid // nz) % ny, cid % nz], dim=-1)


def window_sweep_mask(
    cell_of_agent: torch.Tensor,  # (C,) int32 linear cell id (≥ n_cells: dead)
    dims: tuple,
    block: int,
    half_window: int,
    tile: int,
) -> tuple[slice, slice, torch.Tensor]:
    """Query tile ``tile`` of the sweep: its rows, its window's rows (window
    blocks ``tile ± half_window`` that exist) and the ``(|q|, |w|)`` pair
    mask: 27-box adjacency decoded from the cell ids, both live, no
    self-pair."""
    n_cells = dims[0] * dims[1] * dims[2]
    c = cell_of_agent.shape[0]
    q = slice(tile * block, min((tile + 1) * block, c))
    w = slice(max(tile - half_window, 0) * block, min((tile + half_window + 1) * block, c))
    cid = cell_of_agent.to(torch.int32)
    rows = torch.arange(c, device=cell_of_agent.device)
    pair = (
        ((_cell_coords(cid[q], dims)[:, None, :]
          - _cell_coords(cid[w], dims)[None, :, :]).abs() <= 1).all(dim=-1)
        & (cid[q] < n_cells)[:, None] & (cid[w] < n_cells)[None, :]
        & (rows[q, None] != rows[None, w])
    )
    return q, w, pair


def cell_window_force_ref(
    position: torch.Tensor,       # (C, 3) f32
    radius: torch.Tensor,         # (C,) f32
    cell_of_agent: torch.Tensor,  # (C,) int32 linear cell id (≥ n_cells: dead)
    dims: tuple,                  # (nx, ny, nz)
    k: float = 2.0,
    gamma: float = 1.0,
    block: int = 128,
    half_window: int = 8,
    tiles: tuple[int, int] | None = None,
) -> torch.Tensor:
    """The Morton-window sweep, the plain way: query tile ``i`` (rows
    ``i·block ..``) against the contiguous rows of window blocks
    ``i − half_window .. i + half_window`` that exist, pairs masked by decoded
    27-box adjacency, liveness and row identity.  ``tiles=(lo, hi)``
    evaluates only query tiles ``lo..hi-1`` (other rows get zero)."""
    c = position.shape[0]
    nbw = -(-c // block)
    lo_t, hi_t = (0, nbw) if tiles is None else (int(tiles[0]), int(tiles[1]))
    out = torch.zeros((c, 3), dtype=torch.float32, device=position.device)
    for i in range(lo_t, hi_t):
        q, w, pair = window_sweep_mask(cell_of_agent, dims, block, half_window, i)
        dxc = position[q, None, 0] - position[None, w, 0]
        dyc = position[q, None, 1] - position[None, w, 1]
        dzc = position[q, None, 2] - position[None, w, 2]
        dist = torch.sqrt(dxc * dxc + dyc * dyc + dzc * dzc + 1e-20)
        qr = radius[q, None]
        wr = radius[None, w]
        delta = qr + wr - dist
        overlap = (delta > 0.0) & pair
        rbar = qr * wr / torch.clamp(qr + wr, min=1e-20)
        mag = k * delta - gamma * torch.sqrt(torch.clamp(rbar * delta, min=0.0))
        scale = torch.where(overlap, mag / dist, 0.0)
        # A pair adds only where it overlaps (a non-finite offset adds nothing).
        out[q] = torch.stack([torch.where(overlap, scale * d, 0.0).sum(1)
                              for d in (dxc, dyc, dzc)], dim=-1)
    return out


def window_walk(
    cell_of_agent: torch.Tensor,  # (C,) int32 linear cell id (outside [0, n_cells): dead)
    dims: tuple,
    block: int = 128,
    half_window: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows the window kernel's walk visits, the plain way: each cell's
    first and last row (``scatter_reduce``), the 27 neighbour cells'
    ``[first, last]`` of each live query row clipped to its window's rows,
    sorted by start and cut where they overlap.  Returns ``(start, end)``,
    each ``(C, 27)`` int64: disjoint ascending intervals ``[start, end)``
    inside the window (empty where ``end == start``; a dead row visits
    none)."""
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    c = cell_of_agent.shape[0]
    dev = cell_of_agent.device
    cid = cell_of_agent.long()
    live = (cid >= 0) & (cid < n_cells)
    rows = torch.arange(c, device=dev)
    first = torch.full((n_cells,), c, dtype=torch.long, device=dev).scatter_reduce(
        0, cid[live], rows[live], "amin")
    last = torch.full((n_cells,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, cid[live], rows[live], "amax")
    tile = rows // block
    wlo = ((tile - half_window).clamp(min=0) * block)[:, None]
    whi = ((tile + half_window + 1) * block).clamp(max=c)[:, None]
    nb = (_cell_coords(torch.where(live, cid, 0), dims)[:, None, :]
          + torch.tensor(_OFFSETS, device=dev)[None])                  # (C, 27, 3)
    ok = ((nb >= 0) & (nb < torch.tensor(dims, device=dev))).all(-1) & live[:, None]
    nid = torch.where(ok, (nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2], 0)
    lo = torch.where(ok, torch.maximum(first[nid], wlo), wlo)
    hi = torch.where(ok, torch.minimum(last[nid] + 1, whi), wlo)
    lo, order = lo.sort(dim=1, stable=True)
    hi = hi.gather(1, order)
    walked = torch.cat([wlo, torch.cummax(hi, dim=1).values[:, :-1]], dim=1)
    start = torch.minimum(torch.maximum(lo, torch.maximum(walked, wlo)), whi)
    return start, torch.maximum(hi, start)


def window_walk_pairs(
    cell_of_agent: torch.Tensor, dims: tuple, block: int = 128, half_window: int = 8,
) -> torch.Tensor:
    """``(C, C)`` bool: the pairs (query row, row) that the walk keeps — rows
    it visits that are live, 27-box adjacent by their decoded cells and not
    the query row itself.  For small pools (tests)."""
    n_cells = dims[0] * dims[1] * dims[2]
    start, end = window_walk(cell_of_agent, dims, block, half_window)
    cid = cell_of_agent.long()
    rows = torch.arange(cid.shape[0], device=cid.device)
    visited = ((start[:, :, None] <= rows) & (rows < end[:, :, None])).any(dim=1)
    live = (cid >= 0) & (cid < n_cells)
    coords = _cell_coords(cid, dims)
    adjacent = ((coords[:, None, :] - coords[None, :, :]).abs() <= 1).all(dim=-1)
    return visited & adjacent & live[:, None] & live[None, :] & (rows[:, None] != rows[None, :])
