"""Algorithm 8 as data: the operation scheduler (paper §4.4).

Port of ``repro.core.schedule``.  An :class:`Operation` is a named
``(OpContext, state) -> state`` transform with a phase (``pre`` /
``agent`` / ``post``), a frequency (fires when ``step % frequency == 0``;
0 disables it) and a gate.  :class:`Scheduler` composes them; ``step`` runs
the phase partition in order.

Eager execution replaces the reference's tracing: the step counter is read
to the host once per step, and a frequency gate is a plain ``if`` on it.
The compiled run (``core/runner.py``) steps with :meth:`Scheduler.step_at`
(or a batch's :meth:`Scheduler.step_slots`) with ``branches``: the runner
keeps the counters on the host, the gates read that count, and the ops see
``OpContext.step`` as the device counter (as the reference's traced step
does), with the force pass's branches behind a ``forces.Branches``; the
distributed executor's ``distributed.step_ranks`` does the same for every
rank, each rank's branches under its own scope.
:meth:`Scheduler.step_slots` is the step of a batch of sessions, over the
flat view of its storage (``core/slots.py``): each session keeps its own
counter, an op runs when any live session fires, and each session keeps the
op's result only where it fired itself (a select, as ``vmap`` lowers the
reference's ``lax.cond``).  The default ops are written for the flat view
(``Operation.batched``); a custom op runs once a session, on views of that
session's state and context, and its results are stacked back.
Both gates skip the work when the op does not fire; ``"mask"`` still runs
the op's function (its context writes happen, as in the reference) and
discards the result.  The reference's rounding pins (``seal`` and the
``any(alive)`` fusion fence of the force pass) have no counterpart: eager
PyTorch runs each op on its own and contracts nothing across ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import diffusion as dgrid
from . import lanes, prng
from .behaviors import StepContext
from .forces import Branches, mechanical_forces, update_static_flags_celllist
from .grid import GridIndex, bool_mask, build_index, sort_agents
from .neighbors import NeighborContext
from .slots import select, slot_of, to_flat, to_slots, tree_map
from .spans import CaptureError, span  # noqa: F401 (CaptureError: raised by a step)

PHASES = ("pre", "agent", "post")
GATES = ("cond", "mask")


# ---------------------------------------------------------------------------
# Health telemetry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Saturation / corruption telemetry folded per step by the ``health``
    op; every field is a () int32 tensor.

    pool_overflow:       cumulative agents dropped by pool saturation.
    migrate_overflow:    distributed migration-buffer overflow (0 here).
    halo_overflow:       distributed halo-buffer overflow (0 here).
    cell_overflow_steps: steps on which a grid cell exceeded max_per_cell.
    nonfinite_agents:    live agents with a non-finite position or float
                         attribute on the latest inspected step.
    nonfinite_steps:     cumulative steps with any non-finite live agent.

    A batch's report has (B,) fields, one value a session.
    """

    pool_overflow: torch.Tensor
    migrate_overflow: torch.Tensor
    halo_overflow: torch.Tensor
    cell_overflow_steps: torch.Tensor
    nonfinite_agents: torch.Tensor
    nonfinite_steps: torch.Tensor


HEALTH_FIELDS = tuple(f.name for f in dataclasses.fields(HealthReport))


def empty_health(device: torch.device | str = "cpu") -> HealthReport:
    return HealthReport(**{
        name: torch.zeros((), dtype=torch.int32, device=device)
        for name in HEALTH_FIELDS
    })


# ---------------------------------------------------------------------------
# Operation protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpContext:
    """Per-iteration scratch threaded through the ops of one step.

    config:        the EngineConfig the schedule was built from.
    step:          this iteration's counter (pre-increment), on the host
                   (a tuple, one a session, in a batch's step); under the
                   compiled run the device counter ``state.step``, () int32
                   ((B,) in a batch's step, and a session's context
                   (:meth:`slot`) its () element).
    rng:           this iteration's folded key, (2,) uint32 ((B, 2) in a
                   batch's step).
    index:         the GridIndex built by ``env_build``.
    neighbors:     the step's NeighborContext (lazy dense candidates).
    sctx:          the behaviors' StepContext.
    pre_positions: pool positions at environment-build time (§5.5).
    extras:        free-form scratch for custom ops.
    live:          a batch's step only: a bool a session, the sessions this
                   step advances (the others are rolled back after it).
    branches:      the compiled run's ``forces.Branches`` (None eagerly).
    """

    config: Any
    step: Any
    rng: torch.Tensor
    index: Any = None
    neighbors: Optional[NeighborContext] = None
    sctx: Optional[StepContext] = None
    pre_positions: Optional[torch.Tensor] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    live: Optional[Tuple[bool, ...]] = None
    branches: Optional[Branches] = None

    def slot(self, b: int, rows: int) -> "OpContext":
        """Session ``b``'s context in a batch's step: views of its rows
        (``rows`` a session) of the index, neighbours, step context and
        start positions, its counter and key."""
        n = len(self.live)
        index = neighbors = sctx = pre = None
        if self.index is not None:
            index = GridIndex(
                cell_of_agent=self.index.cell_of_agent.reshape(n, rows)[b],
                cell_list=self.index.cell_list[b], cell_count=self.index.cell_count[b],
                overflowed=self.index.overflowed[b])
        if self.neighbors is not None:
            nb = self.neighbors
            view = lambda x: x.reshape((n, rows) + tuple(x.shape[1:]))[b]
            neighbors = NeighborContext(
                spec=nb.spec, index=index, src_position=view(nb.src_position),
                src_radius=view(nb.src_radius), src_kind=view(nb.src_kind),
                src_alive=view(nb.src_alive), query_position=view(nb.query_position),
                query_alive=view(nb.query_alive))
        if self.sctx is not None:
            sctx = dataclasses.replace(
                self.sctx, rng=self.sctx.rng[b], neighbors=neighbors, step=self.step[b],
                grids={k: dataclasses.replace(g, concentration=g.concentration[b])
                       for k, g in self.sctx.grids.items()})
        if self.pre_positions is not None:
            pre = self.pre_positions.reshape(n, rows, -1)[b]
        return OpContext(config=self.config, step=self.step[b], rng=self.rng[b],
                         index=index, neighbors=neighbors, sctx=sctx, pre_positions=pre,
                         extras=self.extras)


@dataclasses.dataclass(frozen=True)
class Operation:
    """One schedulable unit of Algorithm 8.

    fn:        ``(OpContext, state) -> state`` transform.
    phase:     "pre" | "agent" | "post".
    frequency: fire on iterations where ``step % frequency == 0``; 1 = every
               iteration, 0 = disabled.
    gate:      "cond" (skip the work) or "mask" (run, then keep the old
               state when the op does not fire).
    batched:   ``fn`` also takes the flat view of a batch of sessions and
               its context (the default ops); otherwise a batch's step runs
               it once a session, on that session's views.
    collective: ``fn`` takes the lists of every rank's context and state
               and returns the list of new states (the distributed engine's
               exchanges, ``core/distributed.py``); only the distributed
               executor runs it.
    lane:      the lane in which the distributed executor runs each rank's
               part (``core/lanes.py``): "compute", or "exchange" (the
               overlapped schedule's halo exchange and ghost-extended build,
               beside the interior pass).  Other executors ignore it.
    """

    name: str
    fn: Callable[[OpContext, Any], Any]
    phase: str = "agent"
    frequency: int = 1
    gate: str = "cond"
    batched: bool = False
    collective: bool = False
    lane: str = "compute"

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown phase {self.phase!r}; expected {PHASES}")
        if self.lane not in lanes.ROLES:
            raise ValueError(f"unknown lane {self.lane!r}; expected {lanes.ROLES}")
        if self.gate not in GATES:
            raise ValueError(f"unknown gate {self.gate!r}; expected {GATES}")
        if self.frequency < 0:
            raise ValueError(f"frequency must be >= 0, got {self.frequency}")


def runs_at(op: Operation, step: int) -> bool:
    """Whether ``op``'s function runs on the host count ``step``: never at
    frequency 0; a "cond" op on the multiples of its frequency only; a
    "mask" op every step (:func:`run_op` keeps its result on those
    multiples)."""
    return op.frequency > 0 and (op.gate != "cond" or step % op.frequency == 0)


def run_op(op: Operation, ctx: OpContext, state, step: Optional[int] = None):
    """Execute one op with its frequency gate applied, on ``step`` (the
    host count; default ``ctx.step``)."""
    step = ctx.step if step is None else step
    if not runs_at(op, step):
        return state
    new = op.fn(ctx, state)
    return new if step % op.frequency == 0 else state


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------


def _fold_rng(state, step: int) -> torch.Tensor:
    """Default per-step key derivation: ``fold_in(state.rng, step)``."""
    return prng.fold_in(state.rng, step)


@dataclasses.dataclass(frozen=True)
class Scheduler:
    """An immutable operation schedule; ``step`` is the Algorithm-8 body.

    ``ops`` holds the operations in insertion order; execution partitions
    them by phase (pre → agent → post, stable within each phase).
    """

    config: Any
    ops: Tuple[Operation, ...]
    fold_rng: Callable[[Any, int], torch.Tensor] = _fold_rng

    @classmethod
    def default(cls, config) -> "Scheduler":
        """The default pipeline: sort, env build, behaviors, forces,
        boundary, static flags, diffusion, age, health.  Force ops are
        omitted when ``config.force_params`` is None."""
        ops = [sort_op(config), env_build_op(config), behaviors_op(config)]
        if config.force_params is not None:
            ops.append(forces_op(config))
        ops.append(boundary_op(config))
        if config.force_params is not None:
            ops.append(static_flags_op(config))
        ops.append(diffusion_op(config))
        ops.append(age_op(config))
        ops.append(health_op(config))
        return cls(config=config, ops=tuple(ops))

    def ordered_ops(self) -> Tuple[Operation, ...]:
        """Execution order: the phase partition of ``ops``."""
        return tuple(op for phase in PHASES for op in self.ops if op.phase == phase)

    def step(self, state):
        """One iteration of Algorithm 8 over this schedule."""
        return self.step_at(state, int(state.step))

    def step_at(self, state, step: int, branches: Optional[Branches] = None):
        """One iteration at the host count ``step``, which must equal
        ``state.step`` (it is not read).  With ``branches`` (the compiled
        run, ``core/runner.py``) the ops see ``OpContext.step`` as the
        device counter, the key is folded from it, and the force pass takes
        its branches through ``branches``; an op, or ``fold_rng``, that
        reads the device while the step is captured in a CUDA graph raises
        ``ValueError`` naming it."""
        counter = step if branches is None else state.step
        with span("op.fold_rng"):
            rng = self.fold_rng(state, counter)
        ctx = OpContext(config=self.config, step=counter, rng=rng, branches=branches)
        for op in self.ordered_ops():
            if op.collective:
                raise ValueError(f"op {op.name!r} is collective: it runs in the "
                                 f"distributed executor only")
            if not runs_at(op, step):
                continue
            with span(f"op.{op.name}"):
                state = run_op(op, ctx, state, step)
        return dataclasses.replace(state, step=state.step + 1)

    def step_slots(self, state, live, steps, branches: Optional[Branches] = None):
        """One iteration of Algorithm 8 over the flat view of a batch of
        sessions (``core/slots.py``).  ``live`` and ``steps`` are a bool and
        the pre-increment counter a session, on the host (not read from the
        device).  Every counter advances; the caller rolls the sessions that
        are not live back.  With ``branches`` (the compiled run) the ops see
        ``OpContext.step`` as the (B,) device counter and the force pass
        takes its branches through ``branches``, as in :meth:`step_at`; an
        op or ``fold_rng`` that reads the device during a capture raises
        ``CaptureError`` naming it."""
        live, steps = tuple(bool(x) for x in live), tuple(int(x) for x in steps)
        with span("op.fold_rng"):
            rng = self.fold_rng(state, state.step)
        ctx = OpContext(config=self.config, step=steps if branches is None else state.step,
                        rng=rng, live=live, branches=branches)
        for op in self.ordered_ops():
            if op.frequency == 0:
                continue
            fires = tuple(l and s % op.frequency == 0 for l, s in zip(live, steps))
            if op.gate == "cond" and not any(fires):
                continue
            with span(f"op.{op.name}"):
                if op.batched:
                    new = op.fn(ctx, state)
                    if any(l and not f for l, f in zip(live, fires)):
                        keep = bool_mask(fires, state.step.device)
                        new = to_flat(select(keep, to_slots(new), to_slots(state)))
                    state = new
                else:
                    state = _run_per_slot(op, ctx, state, fires)
        return dataclasses.replace(state, step=state.step + 1)

    # -- composition --------------------------------------------------------

    def op_names(self) -> Tuple[str, ...]:
        return tuple(op.name for op in self.ops)

    def _index_of(self, name: str) -> int:
        names = self.op_names()
        if names.count(name) == 0:
            raise KeyError(f"no op named {name!r}; have {names}")
        if names.count(name) > 1:
            raise KeyError(f"ambiguous op name {name!r} in {names}")
        return names.index(name)

    def _check_new(self, op: Operation):
        if op.name in self.op_names():
            raise KeyError(f"op named {op.name!r} already scheduled")

    def insert_after(self, anchor: str, op: Operation) -> "Scheduler":
        self._check_new(op)
        i = self._index_of(anchor) + 1
        return dataclasses.replace(self, ops=self.ops[:i] + (op,) + self.ops[i:])

    def insert_before(self, anchor: str, op: Operation) -> "Scheduler":
        self._check_new(op)
        i = self._index_of(anchor)
        return dataclasses.replace(self, ops=self.ops[:i] + (op,) + self.ops[i:])

    def append(self, op: Operation) -> "Scheduler":
        self._check_new(op)
        return dataclasses.replace(self, ops=self.ops + (op,))

    def replace_op(self, name: str, op: Operation) -> "Scheduler":
        """Swap the op named ``name`` for ``op``, keeping its position."""
        i = self._index_of(name)
        if op.name != name:
            self._check_new(op)
        return dataclasses.replace(self, ops=self.ops[:i] + (op,) + self.ops[i + 1:])

    def remove_op(self, name: str) -> "Scheduler":
        i = self._index_of(name)
        return dataclasses.replace(self, ops=self.ops[:i] + self.ops[i + 1:])


def _run_per_slot(op: Operation, ctx: OpContext, state, fires):
    """A custom op in a batch's step: once a live session (a "cond" op only
    where it fires), on views of the session's state and context; the
    sessions where it fired take its result, stacked back leaf by leaf."""
    slots = to_slots(state)
    rows = state.pool.capacity // len(fires)
    pairs = []
    for b, (live, fired) in enumerate(zip(ctx.live, fires)):
        if not live or (op.gate == "cond" and not fired):
            continue
        view = slot_of(slots, b)
        out = op.fn(ctx.slot(b, rows), view)
        if fired:
            pairs.append((b, view, out))
    if not pairs:
        return state

    def stack(old, *leaves):
        changed = [(b, new) for (b, _, _), view, new in zip(pairs, leaves[::2], leaves[1::2])
                   if new is not view]
        if not changed:
            return old
        old = old.clone()
        for b, new in changed:
            old[b] = new
        return old

    trees = [t for _, view, out in pairs for t in (view, out)]
    return to_flat(tree_map(stack, slots, *trees))


# ---------------------------------------------------------------------------
# Default operations
# ---------------------------------------------------------------------------


def apply_boundary(config, position: torch.Tensor) -> torch.Tensor:
    """§4.4.11 boundary policies over ``[min_bound, max_bound]``."""
    lo, hi = config.min_bound, config.max_bound
    if config.boundary == "closed":
        return torch.clamp(position, lo, hi)
    if config.boundary == "toroidal":
        return lo + torch.remainder(position - lo, hi - lo)
    return position


def sort_op(config) -> Operation:
    """§5.4.2 agent sorting at its configured frequency (pre standalone)."""

    def fn(ctx: OpContext, state):
        return dataclasses.replace(state, pool=sort_agents(config.spec, state.pool))

    return Operation("sort", fn, phase="pre", frequency=config.sort_frequency,
                     gate="cond", batched=True)


def env_build_op(config) -> Operation:
    """Environment build (pre standalone): one GridIndex + lazy
    NeighborContext per iteration, the step-start positions and the
    behaviors' StepContext, published on the OpContext.  At
    ``sort_frequency=1`` the pool was just layout-sorted, so the build skips
    the within-cell rank pass."""

    def fn(ctx: OpContext, state):
        index = build_index(config.spec, state.pool,
                            assume_sorted=config.sort_frequency == 1)
        ctx.index = index
        ctx.neighbors = NeighborContext.for_pool(config.spec, index, state.pool)
        ctx.neighbors.masked = ctx.branches is not None and ctx.branches.assuming
        ctx.pre_positions = state.pool.position
        ctx.sctx = StepContext(
            rng=ctx.rng,
            grids=dict(state.grids),
            neighbors=ctx.neighbors,
            dt=torch.full((), config.dt, dtype=torch.float32,
                          device=state.pool.device),
            step=ctx.step,
            min_bound=config.min_bound,
            max_bound=config.max_bound,
        )
        return state

    return Operation("env_build", fn, phase="pre", batched=True)


def behaviors_op(config) -> Operation:
    """The agent-op loop (Algorithm 8 L7–11)."""

    def fn(ctx: OpContext, state):
        sctx, pool = ctx.sctx, state.pool
        for behavior in config.behaviors:
            sctx, pool = behavior(sctx, pool)
        ctx.sctx = sctx
        return dataclasses.replace(state, pool=pool, grids=dict(sctx.grids))

    return Operation("behaviors", fn, phase="agent", batched=True)


def force_pass(config, ctx: OpContext, state, *, index=None, neighbors=None,
               row_mask=None, scope: Optional[str] = None) -> torch.Tensor:
    """One ``mechanical_forces`` dispatch with the config's knobs applied,
    over the step's index and context unless ``index`` / ``neighbors`` are
    given (the distributed overlapped schedule runs an interior pass over a
    local-only index and a shell pass over the ghost-extended one, each
    under its own ``scope`` of the compiled run's branches).  In the
    distributed step the issuing lane's record is noted once the pass has
    read its inputs (``lanes.force_pass_issued``, read by
    ``distributed.overlap_report``)."""
    branches = ctx.branches
    if branches is not None and scope is not None:
        branches = branches.scoped(scope)
    force = mechanical_forces(
        config.spec,
        ctx.index if index is None else index,
        state.pool,
        config.force_params,
        active_capacity=config.active_capacity,
        impl=config.force_impl,
        neighbors=ctx.neighbors if neighbors is None else neighbors,
        fused_fallback=config.fused_overflow_fallback,
        tile=config.force_tile,
        tile_order=config.tile_order,
        row_mask=row_mask,
        morton_block=config.morton_block,
        morton_window=config.morton_window,
        morton_fallback=config.morton_window_fallback,
        live=ctx.live,
        branches=branches,
    )
    lanes.force_pass_issued()
    return force


def apply_force(pool, force: torch.Tensor, dt: float):
    """``position += force · dt``, the product rounded on its own."""
    return pool.replace(position=pool.position + force * dt)


def forces_op(config) -> Operation:
    """Mechanical forces (§4.5.1) + displacement (agent op)."""

    def fn(ctx: OpContext, state):
        force = force_pass(config, ctx, state)
        return dataclasses.replace(state, pool=apply_force(state.pool, force, config.dt))

    return Operation("forces", fn, phase="agent", batched=True)


def boundary_op(config) -> Operation:
    """§4.4.11 boundary condition (post standalone)."""

    def fn(ctx: OpContext, state):
        pool = state.pool
        return dataclasses.replace(
            state, pool=pool.replace(position=apply_boundary(config, pool.position))
        )

    return Operation("boundary", fn, phase="post", batched=True)


def static_flags_op(config) -> Operation:
    """§5.5 static-agent detection for the next iteration (post standalone).
    Over ghost-extended sources a live halo row counts as moved."""

    def fn(ctx: OpContext, state):
        pool = state.pool
        nb = ctx.neighbors
        ghost_alive = None
        if nb.src_alive.shape[0] != pool.capacity:
            ghost_alive = nb.src_alive[pool.capacity:]
        pool = update_static_flags_celllist(
            config.spec, ctx.index, pool, pool.position - ctx.pre_positions,
            config.force_params, query_position=nb.query_position,
            ghost_alive=ghost_alive,
        )
        return dataclasses.replace(state, pool=pool)

    return Operation("static_flags", fn, phase="post", batched=True)


def diffusion_op(config) -> Operation:
    """Extracellular diffusion (Eq 4.3) at its frequency; dt is scaled by the
    frequency so skipped iterations are integrated on the firing one."""

    def fn(ctx: OpContext, state):
        if not state.grids:
            return state
        dt = config.dt * max(config.diffusion_frequency, 1)
        grids = {
            name: dgrid.diffuse(g, dt, impl=config.diffusion_impl)
            for name, g in state.grids.items()
        }
        return dataclasses.replace(state, grids=grids)

    return Operation("diffusion", fn, phase="post",
                     frequency=config.diffusion_frequency, gate="cond", batched=True)


def age_op(config) -> Operation:
    """Advance the age of live agents (post standalone)."""

    def fn(ctx: OpContext, state):
        pool = state.pool
        pool = pool.replace(age=pool.age + torch.where(pool.alive, config.dt, 0.0))
        return dataclasses.replace(state, pool=pool)

    return Operation("age", fn, phase="post", batched=True)


def health_op(config) -> Operation:
    """Fold saturation / corruption telemetry into ``state.health`` (last
    post op).  Pure reductions on the device; nothing is read to the host.
    The distributed exchange counters are read from a state that carries
    them (``DistState``) and stay 0 otherwise."""

    def fn(ctx: OpContext, state):
        pool = state.pool
        bad = ~torch.isfinite(pool.position).all(dim=-1)
        bad |= ~torch.isfinite(pool.diameter) | ~torch.isfinite(pool.age)
        for v in pool.attrs.values():
            if v.is_floating_point():
                bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=-1)
        n_bad = pool.slot_sum(bad & pool.alive)
        prev = state.health
        cell_ovf = (
            ctx.index.overflowed.to(torch.int32) if ctx.index is not None
            else torch.zeros_like(pool.overflow, dtype=torch.int32)
        )
        exchange = {name: getattr(state, name).to(torch.int32)
                    for name in ("migrate_overflow", "halo_overflow")
                    if hasattr(state, name)}
        report = dataclasses.replace(
            prev,
            **exchange,
            pool_overflow=pool.overflow.to(torch.int32),
            cell_overflow_steps=prev.cell_overflow_steps + cell_ovf,
            nonfinite_agents=n_bad,
            nonfinite_steps=prev.nonfinite_steps + (n_bad > 0).to(torch.int32),
        )
        return dataclasses.replace(state, health=report)

    return Operation("health", fn, phase="post",
                     frequency=config.health_frequency, gate="cond", batched=True)
