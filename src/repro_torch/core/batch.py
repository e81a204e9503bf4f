"""Many-simulation batch engine: one step, B independent sessions.

Port of ``repro.core.batch``.  The reference batches by ``jax.vmap`` of the
whole step, which gives every Pallas kernel a slot grid axis for free.  The
port writes the slot axis out (``core/slots.py``): the storage is the
reference's, one ``SimulationState`` whose every leaf carries a leading slot
axis, and :meth:`~repro_torch.core.schedule.Scheduler.step_slots` steps its
flat view, so each kernel of the step is launched once for all B sessions
and the host's dispatch, the cost of an eager step, is paid once.

  * :class:`BatchState` — B stacked ``SimulationState``s + a per-slot
    ``active`` mask and an absolute per-slot step budget ``stop_step``.  A
    slot is *live* when ``active & (step < stop_step)``; after each step the
    slots that were not live are rolled back by a select, so finished and
    empty slots are bit-frozen (counter, key and health included).
  * :func:`batched_run` — the step loop, recording observables per slot by
    each slot's own counter into ``⌈n/k⌉``-row buffers plus counts;
    :func:`jitted_batched_runner` — the same run with the step replayed
    from CUDA graphs (``core/runner.py``), bit for bit.
  * :class:`BatchedSimulation` — the lifecycle surface: sweep states
    (per-slot keys and overrides), checkpoint-grade injection into a free
    slot, eviction, all validated against the built template.

Bit-exactness contract (``tests/test_torch_batch.py``, and on the card
``chip_smoke.py``): slot ``b`` of a batched run equals a solo run of that
session, leaf for leaf, including frequency-k series and misaligned chunk
starts.  Every reduction of the step is within a session and every id is
offset per session after it has been clamped, so one session's NaN cannot
reach another.  Observables and custom ops see solo states (views of one
slot); the built-in ops and ``count_kinds`` run batched.  Behaviours run on
the flat view: the built-in ones (and any written with the engine's
primitives: ``prng``, ``add_agents``, the diffusion coupling, the
candidate tensors) are session-aware through those primitives.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import engine as _engine
from . import prng
from . import runner as _runner
from .agents import as_tensor
from .engine import SimulationState
from .schedule import Scheduler
from .slots import select, slot_of, to_flat, to_slots, tree_map
from .spans import span

#: Budget sentinel: a step bound no session reaches (i32-safe).
NO_BUDGET = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class BatchState:
    """B independent simulations as one state.

    states:    a ``SimulationState`` whose every leaf carries a leading slot
               axis of size B (slot ``b``'s simulation is
               ``slot_state(bstate, b)``).
    active:    (B,) bool — slot occupancy.  Inactive slots hold placeholder
               state (usually the built template) and are bit-frozen.
    stop_step: (B,) i32 — absolute per-slot step budget; :data:`NO_BUDGET`
               disables the bound.
    """

    states: SimulationState
    active: torch.Tensor
    stop_step: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.active.shape[0]

    def live(self) -> torch.Tensor:
        """(B,) bool — slots that will advance on the next iteration."""
        return self.active & (self.states.step < self.stop_step)


def broadcast_template(template: SimulationState, batch: int) -> SimulationState:
    """Replicate one state across ``batch`` slots (leaves gain a slot axis;
    each slot owns its copy)."""
    return tree_map(lambda l: l.unsqueeze(0).expand((batch,) + tuple(l.shape)).clone(),
                    template)


def slot_state(bstate: BatchState, slot: int) -> SimulationState:
    """Slot ``slot``'s simulation as a solo ``SimulationState`` (a copy)."""
    return tree_map(lambda l: l[slot].clone(), bstate.states)


# ---------------------------------------------------------------------------
# The batched runner
# ---------------------------------------------------------------------------


def _observe(fn, states: SimulationState, slots: Sequence[int]) -> Dict[int, torch.Tensor]:
    """``fn`` on each of ``slots`` of a slots-layout state.  The built-in
    kind counts (``observe_kinds``: ``n_kinds`` fixed) run once over the
    batch; any other observable once a slot, on a solo view."""
    n_kinds = fn.keywords.get("n_kinds") if isinstance(fn, functools.partial) else None
    if n_kinds is not None and fn.func is _engine.count_kinds and not fn.args:
        pool = states.pool
        ks = torch.arange(n_kinds, device=pool.kind.device)
        onehot = (pool.kind[..., None] == ks) & pool.alive[..., None]
        counts = onehot.sum(dim=1, dtype=torch.int32)
        return {b: counts[b] for b in slots}
    return {b: torch.as_tensor(fn(slot_of(states, b))) for b in slots}


def batched_run(
    config,
    bstate: BatchState,
    n_steps: int,
    scheduler: Optional[Scheduler] = None,
    observables: Optional[Tuple[Tuple[str, Any, int], ...]] = None,
):
    """Run ``n_steps`` iterations of the batched step over a slot batch.

    Per iteration the (B,) step counters are read once; the scheduler's
    :meth:`~Scheduler.step_slots` advances the flat view, and every slot
    that was not live is rolled back to its pre-step value (a select), so a
    slot that exhausts its ``stop_step`` budget stops exactly on it.  Once no
    slot is live the remaining iterations are no-ops and are skipped.

    Observables are the engine's ``(name, fn, frequency)`` triples recorded
    per slot: slot ``b`` fires on iterations whose pre-increment counter is
    ``≡ 0 (mod k)`` *by its own counter*, writing ``fn`` of its post-step
    state into row ``counts[b]`` of a ``⌈n_steps/k⌉``-row buffer (rows
    beyond a slot's firing count stay zero).

    Returns ``(bstate', obs, counts)`` with ``obs[name]`` of shape
    ``(B, ⌈n_steps/k⌉, ...)`` and ``counts[name]`` (B,) i32 rows written.
    """
    sched = scheduler or Scheduler.default(config)
    batch = bstate.batch_size
    dev = bstate.active.device

    obs = tuple(observables or ())
    names = [n for n, _, _ in obs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate observable names in {names}")
    live_obs = tuple((n, f, k) for n, f, k in obs if k > 0)
    rows_of = {name: -(-int(n_steps) // k) for name, _, k in live_obs}
    bufs: Dict[str, torch.Tensor] = {}
    idx = {name: [0] * batch for name, _, _ in live_obs}

    active = bstate.active.tolist()
    stop = bstate.stop_step.tolist()
    states = bstate.states
    for _ in range(int(n_steps)):
        pre = states.step.tolist()
        live = [a and p < s for a, p, s in zip(active, pre, stop)]
        if not any(live):
            break
        stepped = to_slots(sched.step_slots(to_flat(states), live, pre))
        if not all(live):
            stepped = select(bstate.active & (states.step < bstate.stop_step), stepped, states)
        states = stepped
        for name, fn, k in live_obs:
            firing = [b for b in range(batch) if live[b] and pre[b] % k == 0]
            if not firing:
                continue
            rows = _observe(fn, states, firing)
            if name not in bufs:
                proto = rows[firing[0]]
                bufs[name] = torch.zeros((batch, rows_of[name]) + tuple(proto.shape),
                                         dtype=proto.dtype, device=proto.device)
            for b in firing:
                bufs[name][b, idx[name][b]] = rows[b]
                idx[name][b] += 1

    out = {}
    for name, fn, _ in live_obs:
        if name not in bufs:
            proto = _observe(fn, states, [0])[0]
            bufs[name] = torch.zeros((batch, rows_of[name]) + tuple(proto.shape),
                                     dtype=proto.dtype, device=proto.device)
        out[name] = bufs[name]
    counts = {name: torch.tensor(i, dtype=torch.int32, device=dev) for name, i in idx.items()}
    return dataclasses.replace(bstate, states=states), out, counts


def jitted_batched_runner(config, scheduler: Optional[Scheduler] = None) -> _runner.Runner:
    """A reusable compiled runner for :func:`batched_run` (the batch analog
    of :func:`~repro_torch.core.engine.jitted_runner`): ``runner(bstate,
    n_steps, observables=)`` returns :func:`batched_run`'s ``(bstate', obs,
    counts)`` bit for bit, the step replayed from CUDA graphs keyed by the
    live sessions, each session's firings and its branches.  It keeps its
    graphs per batch width, so a serving loop driving chunks of one width
    captures each key once and replays it in every later chunk."""
    return _runner.Runner(config, scheduler, batched=True)


# ---------------------------------------------------------------------------
# Per-slot parameter overrides (the run_batch sweep surface)
# ---------------------------------------------------------------------------


def _unknown_target(key: str) -> ValueError:
    return ValueError(
        f"unknown override target {key!r} — use 'attr:NAME' or "
        f"'substance:NAME' (per-slot op constants ride as attrs)"
    )


def _apply_slot_params(state: SimulationState, params: Dict[str, Any],
                       n_registered: int) -> SimulationState:
    """Apply one slot's override values to one (unbatched) state.

    Key namespace (validated by the callers):

      ``"attr:NAME"``       initial value for agent attr NAME — a scalar
                            (over the live agents; dead padding rows keep
                            their build-time zeros, so the result equals
                            declaring the value in ``add_agents``) or a
                            per-agent ``(n, ...)`` array over the ``n``
                            registered agents.
      ``"substance:NAME"``  initial concentration for substance NAME — a
                            scalar (uniform field) or a full
                            ``(nx, ny, nz)`` field.
    """
    pool, grids = state.pool, dict(state.grids)
    dev = pool.device
    for key, value in params.items():
        space, _, name = key.partition(":")
        value = as_tensor(value, dev)
        if space == "attr":
            arr = pool.attrs[name]
            if value.ndim == 0:
                fill = value.to(arr.dtype).expand(arr.shape)
            else:
                fill = torch.zeros_like(arr)
                fill[:n_registered] = value.to(arr.dtype)
            mask = pool.alive.reshape((-1,) + (1,) * (arr.ndim - 1))
            pool = pool.set_attr(name, torch.where(mask, fill, arr))
        elif space == "substance":
            grid = grids[name]
            conc = value.to(torch.float32).expand(grid.concentration.shape).clone()
            grids[name] = dataclasses.replace(grid, concentration=conc)
        else:
            raise _unknown_target(key)
    return dataclasses.replace(state, pool=pool, grids=grids)


def _check_params(template: SimulationState, params: Dict[str, Any], n_registered: int,
                  batch: Optional[int]) -> int:
    """Host-side sweep validation: every override names a registered target
    and carries a leading slot axis of one consistent size.  Returns B."""
    for key, value in params.items():
        space, _, name = key.partition(":")
        value = np.asarray(value)
        if space == "attr":
            if name not in template.pool.attrs:
                raise ValueError(
                    f"override {key!r}: no attr {name!r} registered "
                    f"(have {sorted(template.pool.attrs)})"
                )
            trailing = tuple(template.pool.attrs[name].shape[1:])
            per_agent = (n_registered,) + trailing
            if value.ndim != 1 and value.shape[1:] != per_agent:
                raise ValueError(
                    f"override {key!r}: per-slot value must be scalar "
                    f"(shape (B,)) or per-agent (shape (B, {n_registered})"
                    f"{' + ' + str(trailing) if trailing else ''}), got "
                    f"{value.shape}"
                )
        elif space == "substance":
            if name not in template.grids:
                raise ValueError(
                    f"override {key!r}: no substance {name!r} registered "
                    f"(have {sorted(template.grids)})"
                )
            res = tuple(template.grids[name].concentration.shape)
            if value.ndim != 1 and value.shape[1:] != res:
                raise ValueError(
                    f"override {key!r}: per-slot value must be scalar "
                    f"(shape (B,)) or a full field (shape (B,) + {res}), "
                    f"got {value.shape}"
                )
        else:
            raise _unknown_target(key)
        if value.ndim == 0 or value.shape[0] == 0:
            raise ValueError(
                f"override {key!r} needs a leading slot axis, got shape "
                f"{value.shape}"
            )
        if batch is None:
            batch = int(value.shape[0])
        elif int(value.shape[0]) != batch:
            raise ValueError(
                f"override {key!r} has {value.shape[0]} slots but the sweep "
                f"is {batch} wide (seeds/overrides must agree)"
            )
    if batch is None:
        raise ValueError(
            "cannot infer the sweep width — pass batch=, seeds=, or at "
            "least one per-slot override"
        )
    return batch


# ---------------------------------------------------------------------------
# The lifecycle surface
# ---------------------------------------------------------------------------


def _leaf_paths(tree):
    """``[(path, leaf)]`` in the checkpoint store's order, paths spelled as
    JAX's ``keystr`` (``.pool.position``, ``.grids['s']``)."""
    from ..checkpoint.checkpoint import _map_with_paths

    out = []

    def visit(path, leaf):
        out.append(("".join(f".{v}" if k == "a" else f"[{v!r}]" for k, v in path), leaf))

    _map_with_paths(tree, visit)
    return out


class BatchedSimulation:
    """Slot-pool lifecycle over one built model.

    Holds the ``(EngineConfig, Scheduler, observables)`` of a
    :class:`~repro_torch.core.api.BuiltSimulation` plus its initial state as
    the *template*: the single source of truth for what a valid session
    state looks like (pool capacity, attr schema, grid shapes).  Construct
    via ``BuiltSimulation.batched()``.
    """

    def __init__(self, config, scheduler: Scheduler, template: SimulationState,
                 observables=()):
        self.config = config
        self.scheduler = scheduler
        self.template = template
        self.observables = tuple(observables)
        self.n_registered = int(template.pool.alive.sum())
        self.device = template.pool.device
        self._runner = functools.partial(batched_run, config, scheduler=scheduler)
        self._jitted = jitted_batched_runner(config, scheduler)

    def _obs_triples(self):
        return tuple(
            (o.name, o.fn, o.frequency)
            for o in self.observables if o.frequency > 0
        )

    # -- state construction -------------------------------------------------

    def empty_state(self, batch: int) -> BatchState:
        """An all-inactive slot pool of the template (a serving loop's
        starting point: admit sessions via :meth:`inject`)."""
        return BatchState(
            states=broadcast_template(self.template, batch),
            active=torch.zeros((batch,), dtype=torch.bool, device=self.device),
            stop_step=torch.full((batch,), NO_BUDGET, dtype=torch.int32, device=self.device),
        )

    def session_state(self, seed: Optional[int] = None,
                      params: Optional[Dict[str, Any]] = None,
                      stream: Optional[int] = None) -> SimulationState:
        """One fresh session from the template: its own key (``seed`` →
        ``PRNGKey(seed)``; else ``fold_in(template.rng, stream)``) and
        optional per-session overrides (unbatched values in the
        :func:`_apply_slot_params` namespace)."""
        if seed is not None:
            rng = prng.PRNGKey(int(seed), device=self.device)
        else:
            rng = prng.fold_in(self.template.rng, int(stream or 0))
        state = dataclasses.replace(self.template, rng=rng)
        if params:
            batched = {k: np.asarray(v)[None] for k, v in params.items()}
            _check_params(self.template, batched, self.n_registered, 1)
            state = _apply_slot_params(state, dict(params), self.n_registered)
        return state

    def sweep_state(self, batch: Optional[int] = None,
                    seeds: Optional[Sequence[int]] = None,
                    params: Optional[Dict[str, Any]] = None) -> BatchState:
        """A B-wide parameter sweep: the template replicated across slots,
        per-slot keys, and per-slot overrides.

        ``params`` values carry a leading slot axis (see
        :func:`_apply_slot_params` for the key namespace); ``seeds`` (B,)
        gives each slot ``PRNGKey(seeds[b])``, defaulting to
        ``fold_in(template.rng, b)`` — distinct, deterministic streams.
        """
        if seeds is not None:
            seeds = np.asarray(seeds)
            if seeds.ndim != 1:
                raise ValueError(f"seeds must be 1-D, got shape {seeds.shape}")
            if batch is None:
                batch = int(seeds.shape[0])
            elif batch != int(seeds.shape[0]):
                raise ValueError(
                    f"batch={batch} but seeds has {seeds.shape[0]} entries"
                )
        if params:
            batch = _check_params(self.template, params, self.n_registered, batch)
        if batch is None:
            raise ValueError(
                "cannot infer the sweep width — pass batch=, seeds=, or at "
                "least one per-slot override"
            )
        if seeds is not None:
            keys = torch.stack([prng.PRNGKey(int(s), device=self.device)
                                for s in seeds.astype(np.int32)])
        else:
            keys = prng.fold_in(self.template.rng,
                                torch.arange(batch, dtype=torch.int32, device=self.device))
        states = []
        for b in range(batch):
            state = dataclasses.replace(self.template, rng=keys[b])
            if params:
                state = _apply_slot_params(
                    state, {k: np.asarray(v)[b] for k, v in params.items()},
                    self.n_registered)
            states.append(state)
        return BatchState(
            states=tree_map(lambda *ls: torch.stack(ls), *states),
            active=torch.ones((batch,), dtype=torch.bool, device=self.device),
            stop_step=torch.full((batch,), NO_BUDGET, dtype=torch.int32, device=self.device),
        )

    # -- slot validation ----------------------------------------------------

    def validate_slot_state(self, state: SimulationState, slot: Any) -> None:
        """Checkpoint-grade admission check: ``state`` must be *this*
        model's state, leaf for leaf.  A pool whose capacity disagrees with
        the declared config gets a dedicated error naming the slot and both
        capacities; any other structure / shape / dtype divergence is named
        by its tree path."""
        got_cap = int(state.pool.position.shape[0])
        want_cap = int(self.template.pool.position.shape[0])
        if got_cap != want_cap:
            raise ValueError(
                f"slot {slot}: injected state has pool capacity {got_cap}, "
                f"but this model was built with capacity {want_cap} — "
                f"sessions must be built against the serving model's config"
            )
        want, got = _leaf_paths(self.template), _leaf_paths(state)
        if [p for p, _ in want] != [p for p, _ in got]:
            raise ValueError(
                f"slot {slot}: injected state's pytree structure does not "
                f"match the built model (different attrs/substances?)"
            )
        for (path, w), (_, g) in zip(want, got):
            if tuple(w.shape) != tuple(g.shape) or w.dtype != g.dtype:
                raise ValueError(
                    f"slot {slot}: leaf {path} has shape {tuple(g.shape)} dtype "
                    f"{g.dtype}, model declares {tuple(w.shape)} {w.dtype}"
                )

    def stack(self, states: Sequence[SimulationState],
              budgets: Optional[Sequence[int]] = None) -> BatchState:
        """Stack explicit session states into a fully-active batch (every
        state validated against the template, errors naming the slot).
        ``budgets[b]`` bounds slot ``b`` to that many further steps.  A
        ``batch.stack`` span (``core/spans.py``); counted, with its host
        seconds, in the runner's ``stats["stacks"]`` and ``["stack_s"]``."""
        with span("batch.stack"):
            t0 = time.perf_counter()
            if not states:
                raise ValueError("stack needs at least one state")
            for b, st in enumerate(states):
                self.validate_slot_state(st, b)
            stacked = tree_map(lambda *ls: torch.stack([l.to(self.device) for l in ls]), *states)
            batch = len(states)
            stop = torch.full((batch,), NO_BUDGET, dtype=torch.int32, device=self.device)
            if budgets is not None:
                if len(budgets) != batch:
                    raise ValueError(f"{len(budgets)} budgets for {batch} states")
                stop = stacked.step + torch.tensor(budgets, dtype=torch.int32, device=self.device)
            out = BatchState(states=stacked,
                             active=torch.ones((batch,), dtype=torch.bool, device=self.device),
                             stop_step=stop)
            self._jitted.stats["stack_s"] += time.perf_counter() - t0
            self._jitted.stats["stacks"] += 1
            return out

    # -- slot lifecycle (between chunks; host-side) -------------------------

    def inject(self, bstate: BatchState, slot: int, state: SimulationState,
               budget: Optional[int] = None) -> BatchState:
        """Admit a session into a free slot: checkpoint-grade state
        injection (validated against the template) + activation.  ``budget``
        bounds the session to that many further steps from its current
        counter."""
        slot = int(slot)
        if bool(bstate.active[slot]):
            raise ValueError(f"slot {slot} is occupied — evict it first")
        self.validate_slot_state(state, slot)

        def put(big, one):
            big = big.clone()
            big[slot] = one
            return big

        stop = NO_BUDGET if budget is None else int(state.step) + int(budget)
        return BatchState(
            states=tree_map(put, bstate.states, state),
            active=put(bstate.active, True),
            stop_step=put(bstate.stop_step, stop),
        )

    def evict(self, bstate: BatchState, slot: int) -> Tuple[SimulationState, BatchState]:
        """Retire slot ``slot``: return its session state (checkpoint-grade
        — resumable later via :meth:`inject`) and the batch with the slot
        freed (state left in place but bit-frozen)."""
        slot = int(slot)
        active, stop = bstate.active.clone(), bstate.stop_step.clone()
        active[slot] = False
        stop[slot] = NO_BUDGET
        return slot_state(bstate, slot), dataclasses.replace(bstate, active=active,
                                                             stop_step=stop)

    # -- execution ----------------------------------------------------------

    def run(self, bstate: BatchState, n_steps: int):
        """Eager batched run → ``(bstate', obs, counts)``."""
        return self._runner(bstate, n_steps, observables=self._obs_triples() or None)

    def run_jit(self, bstate: BatchState, n_steps: int):
        """Compiled batched run → :meth:`run`'s ``(bstate', obs, counts)``,
        bit for bit: the step replayed from CUDA graphs by one runner for
        this ``BatchedSimulation``'s lifetime, whose graphs are kept per
        batch width (so widths coexist without evicting each other or the
        solo runner).  A ``batch.run_jit`` span (``core/spans.py``)."""
        with span("batch.run_jit"):
            return self._jitted(bstate, n_steps, observables=self._obs_triples() or None)
