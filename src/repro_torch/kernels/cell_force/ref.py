"""Plain PyTorch versions of the two cell-force kernels (Eq 4.1).

``cell_list_force_ref`` is the port of ``repro/kernels/cell_force/ref.py``:
slot-centric like the kernel —
the queries are the agents listed in the cell list — but computed the
obvious way, materializing each query cell's 27-box candidate slots and
summing pair forces.  ``cells=(lo, hi)`` evaluates only query cells
``lo..hi-1`` (agents listed elsewhere get zero), so the dense
``(cells, M, 27·M)`` pair tensors can be built in pieces at full size.
``cell_window_force_ref`` is the Morton-window sweep of the Pallas
``_window_force_kernel``, one query tile at a time.
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
    slot_force = torch.stack(
        [(scale * dxc).sum(2), (scale * dyc).sum(2), (scale * dzc).sum(2)], dim=-1
    )                                                              # (Q, M, 3)

    # Sentinel S and rows ≥ num_out drop: they land in a spare row, cut off.
    slots = q_ids.reshape(-1).long()
    slots = torch.where(slots < out_n, slots, out_n)
    out = torch.zeros((out_n + 1, 3), dtype=torch.float32, device=dev)
    out.index_put_((slots,), slot_force.reshape(-1, 3), accumulate=True)
    return out[:out_n]


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
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    c = position.shape[0]
    nbw = -(-c // block)
    lo_t, hi_t = (0, nbw) if tiles is None else (int(tiles[0]), int(tiles[1]))
    cid = cell_of_agent.to(torch.int32)
    live = cid < n_cells
    coords = torch.stack([cid // (ny * nz), (cid // nz) % ny, cid % nz], dim=-1)
    rows = torch.arange(c, device=position.device)
    out = torch.zeros((c, 3), dtype=torch.float32, device=position.device)
    for i in range(lo_t, hi_t):
        q = slice(i * block, min((i + 1) * block, c))
        w = slice(max(i - half_window, 0) * block, min((i + half_window + 1) * block, c))
        pair = (
            ((coords[q, None, :] - coords[None, w, :]).abs() <= 1).all(dim=-1)
            & live[q, None] & live[None, w]
            & (rows[q, None] != rows[None, w])
        )
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
        out[q] = torch.stack([(scale * dxc).sum(1), (scale * dyc).sum(1),
                              (scale * dzc).sum(1)], dim=-1)
    return out
