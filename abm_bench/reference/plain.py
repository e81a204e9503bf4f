"""Plain PyTorch pieces of a simulation step, shared by the references.

Nothing here imports the program.  Each function is the obvious way to
compute one part of the model's semantics (paper §4.4-§4.5, §5.3-§5.4):
cells of a uniform grid, the Morton layout sort, the 27-box contact forces
of Eq 4.1, the explicit diffusion step of Eq 4.3 and the agent-field
coupling.  ``dtype`` is the working precision of the floats; the control
runs the same code one precision below the configuration's.

A state is a dict of tensors (``snapshot`` in ``harness/check.py`` makes one
from the program's state): per-agent ``position`` (C, 3), ``diameter``,
``kind``, ``age``, ``alive``, ``static``, ``attrs`` {name: (C,)}, the
scalars ``overflow`` and ``step``, ``rng`` (2,) uint32 words as int64,
``fields`` {name: (R, R, R)} and ``health`` {name: int}.
"""

from __future__ import annotations

import math

import torch

OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
PER_AGENT = ("position", "diameter", "kind", "age", "alive", "static")


def cell_coords(position: torch.Tensor, lo: float, box: float, n: int) -> torch.Tensor:
    """(N, 3) int64 cell of each position in an ``n``³ grid of ``box`` boxes
    from ``lo``, clipped into the grid."""
    rel = (position.float() - lo) / torch.tensor(box, dtype=torch.float32,
                                                   device=position.device)
    return torch.floor(rel).to(torch.int64).clamp(0, n - 1)


def linear_id(ijk: torch.Tensor, n: int) -> torch.Tensor:
    return (ijk[..., 0] * n + ijk[..., 1]) * n + ijk[..., 2]


def morton_code(ijk: torch.Tensor) -> torch.Tensor:
    """Bit interleave of (x, y, z), x in bit 0, y in bit 1, z in bit 2."""
    code = torch.zeros(ijk.shape[:-1], dtype=torch.int64, device=ijk.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((ijk[..., axis] >> bit) & 1) << (3 * bit + axis)
    return code


def layout_sort(state: dict, lo: float, box: float, n: int) -> dict:
    """§5.4.2: live agents stably in Morton order of their cells, dead
    agents after them in their old order."""
    code = morton_code(cell_coords(state["position"], lo, box, n))
    code = torch.where(state["alive"], code, torch.full_like(code, 1 << 40))
    perm = torch.sort(code, stable=True).indices
    out = dict(state)
    for name in PER_AGENT:
        out[name] = state[name][perm]
    out["attrs"] = {k: v[perm] for k, v in state["attrs"].items()}
    return out


class Grid:
    """The cell list of one step, built the plain way: the agents of
    ``member`` sorted by cell, each cell's first row and count; an agent
    past ``max_per_cell`` in its cell (by row) is left out, as a full cell
    list leaves it out."""

    def __init__(self, position, member, lo, box, n, max_per_cell):
        self.n = n
        dev = position.device
        self.ijk = cell_coords(position, lo, box, n)
        cid = torch.where(member, linear_id(self.ijk, n), n ** 3)
        order = torch.sort(cid, stable=True).indices
        counts = torch.bincount(cid, minlength=n ** 3 + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(cid)
        rank[order] = torch.arange(cid.numel(), device=dev) - starts[cid[order]]
        self.overflowed = bool((counts[:-1] > max_per_cell).any())
        keep = member & (rank < max_per_cell)
        self.member = keep
        cid = torch.where(keep, cid, n ** 3)
        self.order = torch.sort(cid, stable=True).indices
        self.counts = torch.bincount(cid, minlength=n ** 3 + 1)[:-1]
        self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.widest = int(self.counts.max()) if self.counts.numel() else 0

    def neighbours(self, rows: torch.Tensor):
        """For each of ``rows``: the rows of the members in its 27 boxes,
        (len(rows), 27·widest), and which of those slots hold one."""
        dev = rows.device
        offs = torch.tensor(OFFSETS, dtype=torch.int64, device=dev)
        nb = self.ijk[rows][:, None, :] + offs[None]                      # (R, 27, 3)
        ok = ((nb >= 0) & (nb < self.n)).all(-1)
        cid = linear_id(nb.clamp(0, self.n - 1), self.n)
        k = torch.arange(max(self.widest, 1), device=dev)
        slot = self.starts[cid][..., None] + k                               # (R, 27, W)
        ok = ok[..., None] & (k < self.counts[cid][..., None])
        j = self.order[slot.clamp(max=self.order.numel() - 1)]
        return j.reshape(rows.numel(), -1), ok.reshape(rows.numel(), -1)


def contact_forces(grid: Grid, position, radius, k: float, gamma: float, dtype,
                   pairs_a_block: int = 1 << 24) -> torch.Tensor:
    """Eq 4.1 summed over every other member in an agent's 27 boxes, for
    every member (others get zero).  Positions and radii are the current
    ones; membership and boxes are the step's grid."""
    c = position.shape[0]
    dev = position.device
    acc = torch.float64 if dtype == torch.float32 else dtype
    out = torch.zeros((c, 3), dtype=acc, device=dev)
    members = torch.nonzero(grid.member).reshape(-1)
    width = 27 * max(grid.widest, 1)
    step = max(1, pairs_a_block // width)
    pos, rad = position.to(dtype), radius.to(dtype)
    for a in range(0, members.numel(), step):
        rows = members[a:a + step]
        j, ok = grid.neighbours(rows)
        ok = ok & (j != rows[:, None])
        dx = pos[rows][:, None, :] - pos[j]
        dist = torch.sqrt((dx * dx).sum(-1) + 1e-20)
        r1, r2 = rad[rows][:, None], rad[j]
        delta = r1 + r2 - dist
        rbar = r1 * r2 / (r1 + r2)
        mag = k * delta - gamma * torch.sqrt(torch.clamp(rbar * delta, min=0.0))
        on = ok & (delta > 0)
        f = torch.where(on[..., None], (mag / dist)[..., None] * dx, 0.0)
        out[rows] = f.to(acc).sum(1)
    return out.to(dtype)


def moved_static(grid: Grid, pre_position, position, alive, tolerance: float,
                 lo: float, box: float, n: int) -> torch.Tensor:
    """§5.5: an agent is static when neither it nor any member of its 27
    boxes (boxes of its position at the step's start) moved more than
    ``tolerance`` this step."""
    disp = (position.float() - pre_position.float())
    moved = (torch.sqrt((disp * disp).sum(-1)) > tolerance) & alive
    cell_moved = torch.zeros(n ** 3 + 1, dtype=torch.bool, device=position.device)
    cid = torch.where(grid.member, linear_id(grid.ijk, n), n ** 3)
    cell_moved.index_fill_(0, cid[moved & grid.member], True)
    ijk = cell_coords(pre_position, lo, box, n)
    offs = torch.tensor(OFFSETS, dtype=torch.int64, device=position.device)
    nb = ijk[:, None, :] + offs[None]
    ok = ((nb >= 0) & (nb < n)).all(-1)
    near = (cell_moved[linear_id(nb.clamp(0, n - 1), n)] & ok).any(1)
    return alive & ~moved & ~near


def voxel(position, origin: float, spacing: float, res: int) -> torch.Tensor:
    """Flat index of each position's nearest voxel centre (half to even)."""
    rel = (position.float() - origin) / torch.tensor(spacing, dtype=torch.float32,
                                                      device=position.device) - 0.5
    ijk = torch.round(rel).to(torch.int64).clamp(0, res - 1)
    return linear_id(ijk, res), ijk


def secrete(field, position, mask, amount: float, origin, spacing) -> torch.Tensor:
    """Add ``amount`` at the nearest voxel of each masked agent."""
    res = field.shape[0]
    flat, _ = voxel(position, origin, spacing, res)
    count = torch.zeros(res ** 3, dtype=torch.float32, device=field.device)
    count.index_add_(0, flat[mask], torch.ones_like(flat[mask], dtype=torch.float32))
    return (field.reshape(-1) + (amount * count).to(field.dtype)).reshape(field.shape)


def gradient_unit(field, position, origin, spacing) -> torch.Tensor:
    """Central difference at the nearest voxel (neighbours clipped into the
    grid), scaled to unit length; zero where its length is below 1e-12."""
    res = field.shape[0]
    _, ijk = voxel(position, origin, spacing, res)
    flat = field.reshape(-1)
    parts = []
    for axis in range(3):
        e = torch.zeros(3, dtype=torch.int64, device=field.device)
        e[axis] = 1
        hi = linear_id((ijk + e).clamp(0, res - 1), res)
        lo_ = linear_id((ijk - e).clamp(0, res - 1), res)
        parts.append((flat[hi] - flat[lo_]) / (2.0 * spacing))
    g = torch.stack(parts, -1)
    norm = torch.sqrt((g * g).sum(-1, keepdim=True))
    return torch.where(norm > 1e-12, g / norm.clamp(min=1e-12), torch.zeros_like(g))


def value_at(field, position, origin, spacing) -> torch.Tensor:
    flat, _ = voxel(position, origin, spacing, field.shape[0])
    return field.reshape(-1)[flat]


def diffuse(field, diffusion: float, decay: float, dt: float, spacing: float):
    """Eq 4.3, explicit, central differences, zero outside the grid."""
    z = torch.nn.functional.pad(field, (1, 1, 1, 1, 1, 1))
    lap = (z[2:, 1:-1, 1:-1] + z[:-2, 1:-1, 1:-1] + z[1:-1, 2:, 1:-1]
           + z[1:-1, :-2, 1:-1] + z[1:-1, 1:-1, 2:] + z[1:-1, 1:-1, :-2] - 6.0 * field)
    return field * (1.0 - decay * dt) + (diffusion * dt / spacing ** 2) * lap


def cube_root(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def unit(v: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / norm.clamp(min=1e-12)


def health(state: dict, prev: dict, overflowed: bool) -> dict:
    """The step's telemetry: agents dropped for capacity, steps with an
    overflowing cell, live agents with a non-finite float."""
    bad = ~torch.isfinite(state["position"].float()).all(-1)
    bad |= ~torch.isfinite(state["diameter"].float()) | ~torch.isfinite(state["age"].float())
    for v in state["attrs"].values():
        if v.is_floating_point():
            bad |= ~torch.isfinite(v.float())
    n_bad = int((bad & state["alive"]).sum())
    return dict(prev, pool_overflow=int(state["overflow"]),
                cell_overflow_steps=prev["cell_overflow_steps"] + int(overflowed),
                nonfinite_agents=n_bad,
                nonfinite_steps=prev["nonfinite_steps"] + int(n_bad > 0))


def ball_volume(d: torch.Tensor) -> torch.Tensor:
    return math.pi / 6.0 * d ** 3
