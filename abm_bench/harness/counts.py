"""The work a step needs, counted from its shapes and its state: the
yardstick of the roofline shares.

Each count takes inputs read once and outputs written once, whatever an
implementation reads again, and the operations the function needs for
this state.  They read the same work whatever computes it.  Frozen copies
of ``chip_smoke.py``'s ``box_pairs`` (lines 4026-4034) and of the byte and
operation counts of its ``cell_rank``, ``cell_list_force``,
``cell_window_force`` and ``diffusion3d`` rows (lines 3835-3849, 3925-3935,
4104-4110, 3994: PERF.md §6's "Bound" column).
"""

from __future__ import annotations

import torch

from . import peaks

PAIR_OPS = 12          # f32 operations of one Eq 4.1 pair evaluation


def grid_of(cfg: dict) -> tuple:
    """``(lo, box, n)`` of the configuration's uniform grid."""
    space = cfg["space"]
    lo, hi = (0.0, float(space)) if not isinstance(space, (list, tuple)) else map(float, space)
    box = float(cfg["box_um"])
    return lo, box, int((hi - lo) / box)


def cell_counts(snap: dict, cfg: dict) -> torch.Tensor:
    """(n³,) live agents a box of the state's grid (a work view's own)."""
    if "box_counts" in snap:
        return snap["box_counts"]
    lo, box, n = grid_of(cfg)
    rel = (snap["position"].float() - lo) / torch.tensor(box, device=snap["position"].device)
    ijk = torch.floor(rel).to(torch.int64).clamp(0, n - 1)
    cid = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
    return torch.bincount(cid[snap["alive"]], minlength=n ** 3)


def work_view(snap: dict, cfg: dict) -> dict:
    """What the counts read of a snapshot, kept small: its live agents a box
    (int32, on the snapshot's device) and every tensor as a meta tensor of
    its shape and type."""
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    view = {k: (meta(v) if isinstance(v, torch.Tensor) else
                {a: meta(t) for a, t in v.items()} if k in ("attrs", "fields") else v)
            for k, v in snap.items()}
    view["box_counts"] = cell_counts(snap, cfg).to(torch.int32)
    return view


def box_pairs(counts: torch.Tensor, n: int) -> int:
    """Ordered pairs (i, j), i != j, of agents in 27-adjacent boxes."""
    cnt = counts.long().reshape(n, n, n)
    padded = torch.nn.functional.pad(cnt, (1, 1, 1, 1, 1, 1))
    box27 = sum(padded[a:a + n, b:b + n, c:c + n]
                for a in range(3) for b in range(3) for c in range(3))
    return int((cnt * (box27 - 1)).sum())


def cell_list_force(counts: torch.Tensor, n: int, max_per_cell: int, capacity: int) -> tuple:
    """``(bytes, ops)``: each box's occupied slots and its first empty one in
    32-byte sectors, position and radius of each listed agent, the (C, 3)
    output; 12 operations a pair."""
    cnt = counts.long()
    row = (torch.clamp(cnt + 1, max=max_per_cell) * 4 + 31) // 32 * 32
    listed = torch.clamp(cnt, max=max_per_cell)
    n_bytes = int(row.sum()) + 16 * int(listed.sum()) + 12 * capacity
    return n_bytes, PAIR_OPS * box_pairs(cnt, n)


def cell_window_force(counts: torch.Tensor, n: int, capacity: int) -> tuple:
    """``(bytes, ops)``: position, radius and cell id of every row read
    once, the output written once; 12 operations a pair."""
    return 32 * capacity, PAIR_OPS * box_pairs(counts, n)


def cell_rank(counts: torch.Tensor, rows: int) -> tuple:
    """``(bytes, ops)``: the ids read once and the ranks written once; a
    compare per pair of agents of a box and four operations a row."""
    cnt = counts.long()
    return 8 * rows, int((cnt * cnt).sum()) + 4 * rows


def diffusion(numel: int) -> tuple:
    """``(bytes, ops)`` of one explicit step of a field: read once, written
    once, eight operations a voxel."""
    return 8 * numel, 8 * numel


def state_bytes(snap: dict) -> int:
    """Every declared agent attribute and every field, read once and
    written once."""
    per_agent = [snap[k] for k in ("position", "diameter", "kind", "age", "alive", "static")]
    per_agent += list(snap["attrs"].values())
    leaves = per_agent + list(snap["fields"].values())
    return 2 * sum(t.numel() * t.element_size() for t in leaves)


def roofline_pct(trace, cfg: dict, kernel: str, names: tuple, work) -> float | None:
    """Least time of the traced calls of ``kernel`` over their device time,
    in percent.  ``work(snap, counts, n)`` gives one session's ``(bytes,
    ops)`` of a call at a step's input (a batched call covers every
    session); the calls are spread evenly over the traced steps, each
    counted at its own step's input."""
    if trace is None:
        return None
    calls = trace.launches.get(kernel, 0)
    busy = trace.seconds(names)
    if not calls or busy <= 0 or not trace.states:
        return None
    _, _, n = grid_of(cfg)
    least = 0.0
    for sessions in trace.states:
        n_bytes = n_ops = 0
        for snap in sessions:
            b, o = work(snap, cell_counts(snap, cfg), n)
            n_bytes, n_ops = n_bytes + b, n_ops + o
        least += peaks.least_seconds(n_bytes, n_ops)
    return 100.0 * calls / len(trace.states) * least / busy
