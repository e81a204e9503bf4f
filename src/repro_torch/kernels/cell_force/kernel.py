"""ctypes wrappers of ``csrc/cell_list_force.cu`` and
``csrc/cell_window_force.cu`` (they replace the Pallas
``cell_list_force_planar`` and ``cell_window_force_planar``; the design
notes are in the sources).

Agent order in, agent order out: no planar layout is built.  ``launches``
counts ``cell_list_force_cuda``'s kernel launches and ``window_launches``
``cell_window_force_cuda``'s (one per call each; both take a batch's
sessions in one call and one launch).

``cell_list_force_cuda`` runs one block per ``TILE`` of boxes and stages a
tile's halo in shared memory when it holds at most ``STAGE_BUDGET`` agents;
a crowded tile walks global memory instead and adds one to a counter on the
card, which ``crowded_tiles`` reads (it synchronises: tests and measurement
only).  ``cell_window_force_cuda`` keeps a per-cell (first, last) row table
as scratch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0
window_launches = 0

# Boxes of a cell_list_force tile (x, y, z; z fastest, as in the cell id)
# and the most halo agents a tile stages in shared memory.
TILE = (4, 4, 16)
STAGE_BUDGET = 1024

# Crowded-tile counters on the card, one int32 per device index.
_crowded: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("cell_list_force")
    if not getattr(lib, "_typed", False):
        lib.cell_list_force_launch.argtypes = [
            _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P, _P, _P,
        ]
        lib.cell_list_force_launch.restype = _I
        lib._typed = True
    return lib


def _window_lib():
    lib = _build.load("cell_window_force")
    if not getattr(lib, "_typed", False):
        lib.cell_window_force_launch.argtypes = [
            _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P,
        ]
        lib.cell_window_force_launch.restype = _I
        lib._typed = True
    return lib


def _crowded_counter(device: torch.device) -> torch.Tensor:
    counter = _crowded.get(device.index)
    if counter is None:
        counter = _crowded[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter


def crowded_tiles(device: torch.device, reset: bool = False) -> int:
    """Tiles that took ``cell_list_force``'s global-memory path on ``device``
    (the tensors' device) since the last reset; synchronises."""
    counter = _crowded_counter(torch.device(device))
    n = int(counter.item())
    if reset:
        counter.zero_()
    return n


def _check_cell_list(position, radius, cell_list, dims, num_out) -> tuple:
    """``cell_list_force``'s argument checks; returns (slots, rows a slot,
    rows out a slot)."""
    nx, ny, nz = (int(d) for d in dims)
    slots = cell_list.shape[0] if cell_list.ndim == 3 else 1
    rows = position.shape[0]
    s = rows // slots
    n_cells, m = cell_list.shape[-2:]
    out_n = s if num_out is None else int(num_out)
    if cell_list.ndim not in (2, 3) or n_cells != nx * ny * nz:
        raise ValueError(f"cell_list_force: cell_list has {n_cells} rows "
                         f"({tuple(cell_list.shape)}), dims {dims}")
    if position.shape != (s * slots, 3) or radius.shape != (s * slots,):
        raise ValueError(f"cell_list_force: position {tuple(position.shape)} / "
                         f"radius {tuple(radius.shape)} must be (S, 3) / (S,) a slot, "
                         f"{slots} slots")
    if position.dtype != torch.float32 or radius.dtype != torch.float32:
        raise ValueError("cell_list_force: position and radius must be float32")
    if cell_list.dtype != torch.int32:
        raise ValueError("cell_list_force: cell_list must be int32")
    if not 0 <= out_n <= s:
        raise ValueError(f"cell_list_force: num_out {out_n} outside [0, {s}]")
    if slots > 65535:
        raise ValueError(f"cell_list_force: {slots} slots; at most 65,535")
    return slots, s, out_n


def cell_list_force_meta(position, radius, cell_list, dims, k=2.0, gamma=1.0,
                         num_out=None) -> torch.Tensor:
    """The kernel's output on meta tensors (the dry-run), after its checks:
    launches and counts nothing."""
    slots, _, out_n = _check_cell_list(position, radius, cell_list, dims, num_out)
    return torch.empty((slots * out_n, 3), dtype=torch.float32, device=position.device)


def cell_list_force_cuda(
    position: torch.Tensor,    # (S, 3) f32; (B·S, 3) with a slot axis
    radius: torch.Tensor,      # (S,) f32; (B·S,)
    cell_list: torch.Tensor,   # (n_cells, M) int32, empty slots = S; (B, n_cells, M)
    dims: tuple,
    k: float = 2.0,
    gamma: float = 1.0,
    num_out: int | None = None,
) -> torch.Tensor:
    """Net Eq-4.1 force per agent, ``(num_out, 3)`` f32: every listed agent
    against the other listed agents of its 27-box.  Rows not listed (dead
    agents, agents dropped by an overflowed cell) are zero.

    With a slot axis (``cell_list`` (B, n_cells, M) of within-session ids,
    the B sessions' S rows each stacked in ``position`` / ``radius``) one
    launch computes every session against its own grid: ``(B·num_out, 3)``."""
    global launches
    slots, s, out_n = _check_cell_list(position, radius, cell_list, dims, num_out)
    _build.require_cuda("cell_list_force", position, radius, cell_list)
    out = torch.zeros((slots * out_n, 3), dtype=torch.float32, device=position.device)
    n_cells, m = cell_list.shape[-2:]
    if n_cells == 0 or out_n == 0 or slots == 0:
        return out
    nx, ny, nz = (int(d) for d in dims)
    tx, ty, tz = TILE
    lib = _lib()
    _build.check(
        lib.cell_list_force_launch(
            position.device.index, slots, _build.ptr(position), _build.ptr(radius),
            _build.ptr(cell_list), nx, ny, nz, m, s, out_n, float(k),
            float(gamma), tx, ty, tz, STAGE_BUDGET,
            _build.ptr(_crowded_counter(position.device)), _build.ptr(out),
            _build.stream_of(position),
        ),
        "cell_list_force",
    )
    launches += 1
    return out


def cell_window_force_cuda(
    position: torch.Tensor,       # (C, 3) f32; (B·C, 3) with slots
    radius: torch.Tensor,         # (C,) f32; (B·C,)
    cell_of_agent: torch.Tensor,  # (C,) int32 (≥ n_cells: dead); (B·C,) within-session
    dims: tuple,
    k: float = 2.0,
    gamma: float = 1.0,
    block: int = 128,
    half_window: int = 8,
    slots: int = 1,
) -> torch.Tensor:
    """Net Eq-4.1 force per agent, ``(C, 3)`` f32: each query row of tile
    ``row // block`` against the rows of window blocks ``tile ± half_window``
    (those that exist), pairs masked by 27-box adjacency, liveness and row
    identity.  Dead rows are zero.

    ``slots=B``: the rows are B sessions of C rows each, stacked, with cell
    ids within each session's own grid (never offset per session: the kernel
    decodes ids by division); one launch computes each session against its
    own rows, ``(B·C, 3)``."""
    global window_launches
    nx, ny, nz = (int(d) for d in dims)
    rows = position.shape[0]
    if slots < 1 or rows % slots:
        raise ValueError(f"cell_window_force: {rows} rows do not split into {slots} slots")
    if slots > 65535:
        raise ValueError(f"cell_window_force: {slots} slots; at most 65,535")
    c = rows // slots
    if position.shape != (rows, 3) or radius.shape != (rows,) or cell_of_agent.shape != (rows,):
        raise ValueError(f"cell_window_force: position {tuple(position.shape)} / radius "
                         f"{tuple(radius.shape)} / cell_of_agent "
                         f"{tuple(cell_of_agent.shape)} must be (C, 3) / (C,) / (C,)")
    if position.dtype != torch.float32 or radius.dtype != torch.float32:
        raise ValueError("cell_window_force: position and radius must be float32")
    if cell_of_agent.dtype != torch.int32:
        raise ValueError("cell_window_force: cell_of_agent must be int32")
    if not (0 < block <= 1024 and block & (block - 1) == 0) or half_window < 0:
        raise ValueError(f"cell_window_force: block {block} must be a power of two "
                         f"in [1, 1024] and half_window {half_window} >= 0")
    if c >= 0x7F7F7F7F:
        raise ValueError(f"cell_window_force: {c} rows; the row table holds < 0x7F7F7F7F")
    _build.require_cuda("cell_window_force", position, radius, cell_of_agent)
    out = torch.empty((rows, 3), dtype=torch.float32, device=position.device)
    if rows == 0:
        return out
    # Each session's cells' (first, ~last) row (scratch, filled by the launch).
    span = torch.empty((slots * nx * ny * nz, 2), dtype=torch.int32, device=position.device)
    lib = _window_lib()
    _build.check(
        lib.cell_window_force_launch(
            position.device.index, slots, _build.ptr(position), _build.ptr(radius),
            _build.ptr(cell_of_agent), nx, ny, nz, c, block, half_window, float(k),
            float(gamma), _build.ptr(span), _build.ptr(out), _build.stream_of(position),
        ),
        "cell_window_force",
    )
    window_launches += 1
    return out
