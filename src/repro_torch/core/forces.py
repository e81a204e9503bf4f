"""Mechanical contact forces between spherical agents (§4.5.1, Eq 4.1).

    F_N = k·δ − γ·√(r̄·δ),   δ = r₁ + r₂ − |x₁ − x₂|,   r̄ = r₁r₂/(r₁+r₂)

Port of ``repro.core.forces``.  ``impl="reference"`` sums pair forces over
the dense candidate tensor; ``impl="cuda"`` (the reference's ``"pallas"``)
runs the ``kernels/pairwise_force`` kernel over the same tensor;
``impl="fused"`` runs the cell-list kernel of ``kernels/cell_force``, which
never builds that tensor, or with ``tile_order="morton"`` the Morton-window
kernel over the layout-sorted pool.  A kernel impl on CPU tensors runs the
kernel's plain version.

The reference's data-dependent ``lax.cond``s — the fused path's fallback
when a cell overflowed, the Morton window's coverage gate and the §5.5
compaction's fallback when the active set overflowed — are host-side
``if``s on device predicates here, read in one synchronisation a call.
Under the compiled run (``core/runner.py``) a :class:`Branches` stands in
for that read: the runner's eager steps record which branch each predicate
gave, and its captured steps assume those branches, read nothing, and set a
device ``diverged`` flag wherever a predicate disagrees (the runner then
rolls the steps back and runs them eagerly).  A captured step evaluates the
dense candidates as masked row tiles (:func:`forces_from_candidates`'s
``masked``), whose shapes do not depend on the data; they sum each row in
the order of the eager form, so the bits agree.

Over the flat view of a batch (``core/slots.py``) each session takes its own
branch: the predicates of every session are read in one device-to-host
read, each branch that a live session needs is evaluated for the whole
batch, and each session keeps its own branch's rows, as ``vmap`` lowers the
reference's ``lax.cond`` to a select.  So with ``tile_order="morton"`` a
session whose window covers it takes the window kernel and one whose
window does not the linear kernel, each kernel launched at most once a step
for every session.  A session that is not live takes each predicate's
False branch (its step is rolled back), so only the live sessions' values
choose the kernels.  Under the compiled run a batch's branches are one bool
a session for each predicate, and a captured step sets ``diverged`` where a
live session's predicate differs from its assumed value.

Ghost-extended sources (the distributed engine, ``NeighborContext.
for_sources``): the index and the cell list cover the local pool's C rows
and the halo rows after them; the forces are the C local rows'
(``num_out=C``), and the Morton window is taken only when the sources are
the pool itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .agents import AgentPool, compact_indices
from .grid import (GridIndex, GridSpec, bool_mask, grid_dims, neighbor_cell_ids,
                   neighbor_offsets)
from .neighbors import NeighborContext
from .slots import row_slot

IMPLS = ("reference", "fused", "cuda")
TILE_ORDERS = ("linear", "morton")


def check_impl(impl: str, tile_order: str = "linear") -> None:
    """Raise on a force impl or tile order the port does not know."""
    if impl not in IMPLS:
        hint = " (the port names the reference's 'pallas' 'cuda')" if impl == "pallas" else ""
        raise ValueError(f"unknown force impl {impl!r}{hint}; expected {IMPLS}")
    if tile_order not in TILE_ORDERS:
        raise ValueError(f"unknown tile_order {tile_order!r}; expected {TILE_ORDERS}")


# Candidate slots a masked evaluation takes at a time (rows × 27·M).
MASKED_TILE_SLOTS = 1 << 22


class Branches:
    """The data-dependent branches of one step of the compiled run
    (``core/runner.py``), the counterpart of the reference's ``lax.cond``s.

    Recording (``assumed=None``): a predicate is read to the host, as the
    eager step reads it, and the branch it gives is taken and recorded in
    ``taken``.  Assuming (``assumed``: the ``taken`` of an earlier step,
    ``diverged``: a () bool device tensor): nothing is read; each predicate
    takes its assumed branch, and where its device value differs,
    ``diverged`` is set on the device.  Only the predicates a step consults
    are recorded or checked.  A value is a bool in a solo step and a tuple
    of bools, one a session, in a batch's; there ``diverged`` is set only
    where a live session's predicate differs from its assumed value.

    :meth:`scoped` gives a view whose names carry a prefix and which shares
    the assumed values, the record and ``diverged``: the distributed step
    gives each rank its own scope (``"rank1/"``), and the overlapped
    schedule each of a rank's two force passes (``"rank1/interior/"``), so
    every pass keys and checks its own predicates.  A distributed run's
    ``diverged`` holds a slot a rank ((R,) bool): each rank's view sets its
    own slot only, from its own lane (``core/lanes.py``; the ranks' streams
    never write one byte together), and the runner reduces the slots after
    the ranks' lanes have joined."""

    def __init__(self, assumed: Optional[dict] = None,
                 diverged: Optional[torch.Tensor] = None):
        self.assumed = None if assumed is None else dict(assumed)
        self.diverged = diverged
        self.taken: dict = {}
        self.scope = ""

    @property
    def assuming(self) -> bool:
        return self.assumed is not None

    def key(self) -> tuple:
        """The branches taken, as a hashable key."""
        return tuple(sorted(self.taken.items()))

    def scoped(self, name: str, slot: Optional[int] = None) -> "Branches":
        """A view of these branches whose names are prefixed by ``name/``;
        with ``slot``, and a ``diverged`` with a slot axis, it sets
        ``diverged[slot]`` only."""
        out = Branches.__new__(Branches)
        out.assumed, out.diverged, out.taken = self.assumed, self.diverged, self.taken
        if slot is not None and self.diverged is not None and self.diverged.ndim == 1:
            out.diverged = self.diverged[slot]
        out.scope = f"{self.scope}{name}/"
        return out

    def record(self, name: str, value):
        self.taken[self.scope + name] = value

    def assume(self, name: str, pred: torch.Tensor, live=None):
        """The assumed value of ``name``; ``diverged`` is set where the
        device's ``pred`` (a () bool, or (B,) with ``live`` a bool a session)
        differs from it.  A batch's masks are kept constants
        (``grid.bool_mask``), which the runner makes before the capture."""
        value = self.assumed[self.scope + name]
        if live is None:
            self.diverged.logical_or_(pred.reshape(()) != value)
        else:
            differs = (pred != bool_mask(value, pred.device)) & bool_mask(live, pred.device)
            self.diverged.logical_or_(differs.any())
        self.record(name, value)
        return value


class _Flags:
    """The branch predicates of one force pass: ``flags[name]`` is a list
    of bools, one a session (one for a () predicate).  Without branches, or
    recording, every predicate is read in one device-to-host read; assuming,
    none is.  ``live`` (a batch's: a bool a session, None solo): a session
    that is not live reads False."""

    def __init__(self, tensors: dict, branches: Optional[Branches], live=None):
        self._tensors = tensors
        self._branches = branches
        self._live = live
        assuming = branches is not None and branches.assuming
        self._values = None if assuming else _read_flags(tensors)
        if self._values is not None and live is not None:
            self._values = {n: [bool(v) and l for v, l in zip(vals, live)]
                            for n, vals in self._values.items()}

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    def __getitem__(self, name: str) -> list:
        br = self._branches
        if br is not None and br.assuming:
            value = br.assume(name, self._tensors[name], self._live)
            return [value] if self._live is None else list(value)
        value = self._values[name]
        if br is not None:
            br.record(name, value[0] if self._live is None else tuple(value))
        return value


def _read_flags(flags: dict) -> dict:
    """``{name: () or (B,) bool tensor}`` → ``{name: [bool] a session, or
    one for a () flag}``, in one device-to-host read."""
    if not flags:
        return {}
    parts = [flags[n].reshape(-1) for n in flags]
    values = torch.cat(parts).tolist()
    out, at = {}, 0
    for name, part in zip(flags, parts):
        out[name] = values[at:at + part.numel()]
        at += part.numel()
    return out


def _per_session(pick, a, b, c: int) -> torch.Tensor:
    """Rows of ``a`` for the sessions where ``pick`` (a bool a session) is
    set, of ``b`` elsewhere; each session is ``c`` rows.  The mask is a kept
    constant (``grid.bool_mask``): no host-to-device copy."""
    if all(pick):
        return a
    if not any(pick):
        return b
    n = len(pick)
    keep = bool_mask(pick, a.device).reshape(n, 1, 1)
    return torch.where(keep, a.reshape(n, c, -1), b.reshape(n, c, -1)).reshape(a.shape)


def _window_need(spec: GridSpec, index: GridIndex, block: int) -> torch.Tensor:
    """(C,) int32: the half-window, in blocks of ``block`` rows, that each
    live agent needs to see the lowest and highest row of its 27-box (from
    the stale cell ids the kernels use); 0 for dead rows.  Over a batch's
    flat view, rows and blocks count within each session's own rows."""
    cid = index.cell_of_agent
    rows_all = cid.shape[0]
    b = index.slots or 1
    c = rows_all // b
    dev = cid.device
    n_cells = spec.n_cells
    nx, ny, nz = spec.dims
    slot = row_slot(rows_all, b, dev)
    rows = (torch.arange(rows_all, device=dev) - slot * c).to(torch.int32)
    # Each session's cells and its dead bin: a table of n_cells + 1 a session.
    base = slot * (n_cells + 1)
    ci = base + cid.long().clamp(0, n_cells)   # a negative id is refused by the caller
    rmin = torch.full((b * (n_cells + 1),), c, dtype=torch.int32, device=dev)
    rmin = rmin.scatter_reduce(0, ci, rows, "amin")
    rmax = torch.full((b * (n_cells + 1),), -1, dtype=torch.int32, device=dev)
    rmax = rmax.scatter_reduce(0, ci, rows, "amax")
    ijk = torch.stack([cid // (ny * nz), (cid // nz) % ny, cid % nz], dim=-1)
    nbr = ijk[:, None, :] + neighbor_offsets(dev)[None]                 # (C, 27, 3)
    dims = grid_dims(spec, dev)
    in_range = ((nbr >= 0) & (nbr < dims)).all(dim=-1)
    ncid = torch.clamp((nbr[..., 0] * ny + nbr[..., 1]) * nz + nbr[..., 2], 0, n_cells - 1)
    ncid = base[:, None] + ncid.long()
    nmn = torch.where(in_range, rmin[ncid], c).amin(dim=1)
    nmx = torch.where(in_range, rmax[ncid], -1).amax(dim=1)
    blk = rows // block
    need = torch.maximum(blk - nmn // block, nmx // block - blk)
    return torch.where(cid < n_cells, need, 0)


def _morton_window_ok(spec: GridSpec, index: GridIndex, block: Optional[int],
                      window: Optional[int]) -> torch.Tensor:
    """() bool, or (B,) a session over a batch's flat view: may this step
    run the Morton-window kernel exactly?  True iff every live agent's
    27-box neighbours sit within ``± half_window`` blocks of its own row,
    checked from the actual rows (an unsorted pool simply fails and takes
    the linear path)."""
    from repro_torch.kernels.cell_force import ops as cf_ops

    b = index.slots
    per = index.cell_of_agent.shape[0] // (b or 1)
    bw, h = cf_ops.window_defaults(per, block, window)
    ok = _window_need(spec, index, bw) <= h
    return ok.all() if b is None else ok.reshape(b, per).all(dim=1)


def covering_half_window(spec: GridSpec, index: GridIndex, block: Optional[int] = None
                         ) -> int:
    """The least ``half_window`` (in blocks) for which the Morton coverage
    gate passes on this index (in every session of a batch's)."""
    from repro_torch.kernels.cell_force import ops as cf_ops

    c = index.cell_of_agent.shape[0]
    bw, _ = cf_ops.window_defaults(c // (index.slots or 1), block, None)
    return int(_window_need(spec, index, bw).max()) if c else 0


@dataclasses.dataclass(frozen=True)
class ForceParams:
    """Eq 4.1 parameters.  BioDynaMo/Cortex3D defaults: k=2, γ=1."""

    repulsion_k: float = 2.0
    attraction_gamma: float = 1.0
    # Displacement below this (per iteration) marks an agent "not moved" for
    # the §5.5 static-agent detection.
    static_tolerance: float = 1e-4


def pair_force(dx: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
               params: ForceParams) -> torch.Tensor:
    """Force on agent 1 from agent 2.  dx = x1 - x2, shape (..., 3)."""
    # Explicit left-associated squared distance, as in the reference and the
    # kernels (a reduction's association is implementation-defined).
    d2 = dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1] + dx[..., 2] * dx[..., 2]
    dist = torch.sqrt(d2 + 1e-20)
    delta = r1 + r2 - dist
    overlap = delta > 0.0
    rbar = r1 * r2 / torch.clamp(r1 + r2, min=1e-20)
    magnitude = (
        params.repulsion_k * delta
        - params.attraction_gamma * torch.sqrt(torch.clamp(rbar * delta, min=0.0))
    )
    direction = dx / dist[..., None]
    return torch.where(overlap[..., None], magnitude[..., None] * direction, 0.0)


def _tree_sum(f: torch.Tensor) -> torch.Tensor:
    """Fixed-association pairwise sum over axis 1 (the reference's balanced
    add tree)."""
    k = f.shape[1]
    while k > 1:
        half = k // 2
        s = f[:, :half] + f[:, half:2 * half]
        if k % 2:
            s = torch.cat([s, f[:, 2 * half:]], dim=1)
        f = s
        k = (k + 1) // 2
    return f[:, 0]


def forces_from_candidates(
    position: torch.Tensor,
    radius: torch.Tensor,
    cand: torch.Tensor,
    cand_mask: torch.Tensor,
    params: ForceParams,
    all_position: Optional[torch.Tensor] = None,
    all_radius: Optional[torch.Tensor] = None,
    masked: bool = False,
) -> torch.Tensor:
    """Sum Eq-4.1 forces over each agent's candidate set: ``cand (N, K)``
    indices into the source arrays (default: the query arrays).

    ``masked``: evaluate every slot, in tiles of rows of at most
    ``MASKED_TILE_SLOTS`` slots, and zero the masked-out ones, instead of
    gathering the masked-in slots (whose count is data: ``nonzero`` reads it
    back).  Each row sums the same values in the same order, so the two
    forms agree bit for bit."""
    src_pos = position if all_position is None else all_position
    src_rad = radius if all_radius is None else all_radius
    if masked:
        return _masked_forces(position, radius, cand, cand_mask, params, src_pos, src_rad)
    # Pair forces of the masked-in slots only (most slots are empty), placed
    # into zeros: the same (N, K, 3) values as masking a full evaluation.
    rows, cols = cand_mask.nonzero(as_tuple=True)
    src = cand[rows, cols].long()
    f = torch.zeros(cand.shape + (3,), dtype=position.dtype, device=position.device)
    f[rows, cols] = pair_force(position[rows] - src_pos[src], radius[rows], src_rad[src],
                               params)
    return _tree_sum(f)


def masked_row_tile(n: int, k: int) -> int:
    """Rows a masked evaluation of ``(n, k)`` candidates takes at a time."""
    return max(1, min(n, MASKED_TILE_SLOTS // max(k, 1)))


def _masked_forces(position, radius, cand, cand_mask, params, src_pos, src_rad):
    """:func:`forces_from_candidates` over every slot, in row tiles."""
    n, k = cand.shape
    tile = masked_row_tile(n, k)
    outs = []
    for i in range(0, n, tile):
        mask = cand_mask[i:i + tile]
        src = torch.where(mask, cand[i:i + tile], 0).long()
        f = pair_force(position[i:i + tile, None, :] - src_pos[src],
                       radius[i:i + tile, None], src_rad[src], params)
        outs.append(_tree_sum(torch.where(mask[..., None], f, 0.0)))
    if not outs:
        return torch.zeros((0, 3), dtype=position.dtype, device=position.device)
    return torch.cat(outs, dim=0)


def forces_from_candidates_tiled(
    position, radius, cand, cand_mask, params, all_position, all_radius, tile: int,
    masked: bool = False,
) -> torch.Tensor:
    """Tile-wise :func:`forces_from_candidates`, bounding the (tile, K, 3)
    working set."""
    outs = [
        forces_from_candidates(
            position[i:i + tile], radius[i:i + tile], cand[i:i + tile],
            cand_mask[i:i + tile], params, all_position, all_radius, masked=masked,
        )
        for i in range(0, position.shape[0], tile)
    ]
    if not outs:
        return torch.zeros((0, 3), dtype=torch.float32, device=position.device)
    return torch.cat(outs, dim=0)


def mechanical_forces(
    spec: GridSpec,
    index: GridIndex,
    pool: AgentPool,
    params: ForceParams,
    active_capacity: Optional[int] = None,
    impl: str = "reference",
    neighbors: Optional[NeighborContext] = None,
    fused_fallback: bool = True,
    tile: Optional[int] = None,
    tile_order: str = "linear",
    row_mask: Optional[torch.Tensor] = None,
    morton_block: Optional[int] = None,
    morton_window: Optional[int] = None,
    morton_fallback: bool = True,
    live=None,
    branches: Optional[Branches] = None,
) -> torch.Tensor:
    """Net mechanical force per agent, (C, 3).

    ``impl``: "reference" (dense candidates), "cuda" (the pairwise_force
    kernel over the dense candidates) or "fused" (the cell-list kernel).
    ``tile_order="morton"`` (fused only): the Morton-window kernel with
    ``morton_block`` / ``morton_window`` (see ``window_defaults``), guarded
    by the coverage gate — a failed gate, or an overflowed cell, takes the
    linear kernel — unless ``morton_fallback=False``.
    ``fused_fallback``: when a cell overflowed ``max_per_cell``
    the fused path re-evaluates through the dense candidates (the cell list
    dropped agents).  ``active_capacity``: §5.5 work compaction — only
    ``alive & ~static`` agents are evaluated, through an ``(A, 27M)``
    candidate subset; more active agents than that falls back to the full
    evaluation.  ``tile``: evaluate the dense path in agent tiles.
    ``row_mask``: rows outside it get zero force (output masking only).
    Over a batch's flat view (``index.slots``) ``live`` (a bool a session)
    names the sessions whose branches count; the others take each
    predicate's False branch (their step is rolled back), and a negative
    cell id is refused in a live session only.
    ``branches``: the compiled run's :class:`Branches`; with it a negative
    cell id is checked whenever the Morton kernel is configured, and an
    assuming pass evaluates dense candidates in masked tiles.
    """
    check_impl(impl, tile_order)
    masked = branches is not None and branches.assuming
    if neighbors is None:
        neighbors = NeighborContext.for_pool(spec, index, pool)
    radius = pool.radius()
    c = pool.capacity
    out_mask = pool.alive if row_mask is None else pool.alive & row_mask
    slots = index.slots
    b = slots or 1
    per = c // b
    live = (True,) * b if live is None else tuple(bool(x) for x in live)
    if neighbors.src_position.shape[0] == c:
        # The sources ARE the pool: use its current arrays (behaviors may
        # have moved agents since the context was built).
        src_pos, src_rad = pool.position, radius
    else:
        # Ghost-extended sources (the distributed engine): the local rows
        # refreshed to the pool's current state, the halo rows the
        # exchange-time snapshot.
        src_pos = torch.cat([pool.position, neighbors.src_position[c:]])
        src_rad = torch.cat([radius, neighbors.src_radius[c:]])

    # The Morton window walks the pool's own rows: taken only when the
    # sources are the pool.
    morton = impl == "fused" and tile_order == "morton" and src_pos is pool.position

    # The branch predicates of every session, in one read.
    flags = {}
    if impl == "fused" and fused_fallback:
        flags["overflowed"] = index.overflowed
    if active_capacity is not None:
        flags["crowded"] = pool.slot_sum(pool.alive & ~pool.static) > int(active_capacity)
    ids_checked = morton and (morton_fallback or branches is not None)
    if morton and morton_fallback:
        flags["window"] = (_morton_window_ok(spec, index, morton_block, morton_window)
                           & ~index.overflowed)
    if ids_checked:
        from repro_torch.kernels.cell_force import ops as cf_ops

        flags["negative"] = (cf_ops.negative_ids(index.cell_of_agent) if slots is None
                             else (index.cell_of_agent.reshape(b, per) < 0).any(dim=1))
    flags = _Flags(flags, branches, None if slots is None else live)
    if "negative" in flags:
        cf_ops.reject_negative_ids(any(flags["negative"]))

    def dense_eval(cache: bool) -> torch.Tensor:
        cand, mask = neighbors.candidates(cache=cache)
        if tile:
            return forces_from_candidates_tiled(
                pool.position, radius, cand, mask, params, src_pos, src_rad, tile,
                masked=masked,
            )
        return forces_from_candidates(pool.position, radius, cand, mask, params,
                                      all_position=src_pos, all_radius=src_rad,
                                      masked=masked)

    def fused(use) -> torch.Tensor:
        """The fused kernels' rows; ``use`` (a bool a session) names the
        sessions whose rows count.  Each of those takes the window kernel
        where its coverage gate passed and the linear kernel where it
        failed; each kernel runs at most once, over every session."""
        from repro_torch.kernels.cell_force import ops as cf_ops

        linear = lambda: cf_ops.cell_list_force(
            src_pos, src_rad, index.cell_list, spec.dims,
            k=params.repulsion_k, gamma=params.attraction_gamma,
            impl="cuda", num_out=per,
        )
        if not morton:
            return linear()
        window = lambda: cf_ops.cell_window_force(
            pool.position, radius, index.cell_of_agent, spec.dims,
            k=params.repulsion_k, gamma=params.attraction_gamma,
            block=morton_block, window=morton_window, impl="cuda",
            ids_checked=ids_checked, slots=slots,
        )
        ok = flags["window"] if morton_fallback else [True] * b
        if not any(u and not w for u, w in zip(use, ok)):
            return window()
        if not any(u and w for u, w in zip(use, ok)):
            return linear()
        return _per_session(ok, window(), linear(), per)

    def dense() -> torch.Tensor:
        if impl == "reference":
            return dense_eval(cache=True)
        if impl == "cuda":
            from repro_torch.kernels.pairwise_force import ops as pf_ops

            cand, mask = neighbors.candidates()
            return pf_ops.pairwise_force(
                pool.position, radius, cand, mask,
                k=params.repulsion_k, gamma=params.attraction_gamma, impl="cuda",
                all_position=src_pos, all_radius=src_rad,
            )
        if "overflowed" not in flags:
            return fused(live)
        fall = [f and l for f, l in zip(flags["overflowed"], live)]
        if not any(fall):
            return fused(live)
        if all(f or not l for f, l in zip(flags["overflowed"], live)):
            return dense_eval(cache=False)
        return _per_session(fall, dense_eval(cache=False),
                            fused([l and not f for f, l in zip(fall, live)]), per)

    if active_capacity is None:
        return torch.where(out_mask[:, None], dense(), 0.0)

    # ---- §5.5 static-agent omission via work compaction -------------------
    a = int(active_capacity)
    full = [f and l for f, l in zip(flags["crowded"], live)]
    if all(f or not l for f, l in zip(flags["crowded"], live)):
        return torch.where(out_mask[:, None], dense(), 0.0)
    act_ids, act_valid, _ = compact_indices(pool.per_slot(pool.alive & ~pool.static), a)
    if slots is not None:
        act_ids = act_ids + torch.arange(0, c, per, dtype=torch.int32,
                                         device=pool.device)[:, None]
    act_ids, act_valid = act_ids.reshape(-1), act_valid.reshape(-1)
    cand, mask = neighbors.candidates_for(act_ids, act_valid)
    ids = act_ids.long()
    sub_force = forces_from_candidates(
        pool.position[ids], radius[ids], cand, mask & act_valid[:, None], params,
        all_position=src_pos, all_radius=src_rad, masked=masked,
    )
    force = torch.zeros((c, 3), dtype=sub_force.dtype, device=pool.device)
    force.index_put_((ids,), torch.where(act_valid[:, None], sub_force, 0.0),
                     accumulate=True)
    if any(full):
        force = _per_session(full, dense(), force, per)
    return torch.where(out_mask[:, None], force, 0.0)


def update_static_flags(pool: AgentPool, displacement: torch.Tensor,
                        cand: torch.Tensor, cand_mask: torch.Tensor,
                        params: ForceParams) -> AgentPool:
    """§5.5 static detection over dense candidates: an agent may be skipped
    next iteration iff neither it nor any neighbor moved this iteration."""
    moved = _moved(pool, displacement, params)
    safe = torch.where(cand_mask, cand, 0).long()
    neighbor_moved = (moved[safe] & cand_mask).any(dim=1)
    return pool.replace(static=pool.alive & ~moved & ~neighbor_moved)


def _moved(pool: AgentPool, displacement: torch.Tensor, params: ForceParams):
    norm = torch.sqrt((displacement * displacement).sum(dim=-1))
    return (norm > params.static_tolerance) & pool.alive


def update_static_flags_celllist(
    spec: GridSpec,
    index: GridIndex,
    pool: AgentPool,
    displacement: torch.Tensor,
    params: ForceParams,
    query_position: Optional[torch.Tensor] = None,
    ghost_alive: Optional[torch.Tensor] = None,
) -> AgentPool:
    """§5.5 static detection through the cell list — no dense candidates:
    "any agent in the 27-box moved" from a per-cell any-reduction over
    ``cell_list`` and an (N, 27) cell-level gather.  ``query_position``: the
    positions the index was built from (default: the pool's current ones).
    Over a batch's index each session reads its own cells.

    ``ghost_alive``: alive flags of the source rows beyond the pool (the
    distributed engine's aura agents, ids ≥ ``pool.capacity`` in the cell
    list).  Their displacement is not known locally, so a live ghost counts
    as moved: an agent whose 27-box reaches a live ghost never goes static.
    """
    moved = _moved(pool, displacement, params)
    qpos = pool.position if query_position is None else query_position
    nbr_cid, in_range = neighbor_cell_ids(spec, qpos)                 # (N, 27)
    b = index.slots or 1
    src_moved = moved if ghost_alive is None else torch.cat([moved, ghost_alive])
    per = src_moved.shape[0] // b
    cell_list = index.cell_list.reshape(b, spec.n_cells, -1)
    slot_valid = cell_list < per
    safe = torch.where(slot_valid, cell_list, 0).long()
    if b > 1:
        safe = safe + torch.arange(0, moved.shape[0], per, device=safe.device)[:, None, None]
        base = row_slot(nbr_cid.shape[0], b, nbr_cid.device) * spec.n_cells
        nbr_cid = nbr_cid + base[:, None]
    cell_moved = (src_moved[safe] & slot_valid).any(dim=2).reshape(-1)   # (B·n_cells,)
    neighbor_moved = (cell_moved[nbr_cid.long()] & in_range).any(dim=1)
    return pool.replace(static=pool.alive & ~moved & ~neighbor_moved)
