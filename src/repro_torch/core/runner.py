"""Compiled execution: the engine's step replayed from CUDA graphs.

The counterpart of the reference's ``jax.jit`` over the ``lax.scan`` of the
step (``repro.core.engine.run_jit``, the batch engine's
``repro.core.batch.jitted_batched_runner`` and the distributed engine's
``jit(shard_map(step))``, ``repro.core.distributed.make_distributed_step``):
a :class:`Runner` captures the step of one (config, scheduler) in
``torch.cuda.CUDAGraph``s and replays them — the solo step
(``Scheduler.step_at``), with ``batched=True`` the step of a batch of
sessions (``Scheduler.step_slots`` over a ``batch.BatchState``), or with a
``mesh`` the lock-step step of every rank of the distributed engine
(``distributed.step_ranks`` over the stacked ``DistState``) — and its
results are the eager run's (:func:`~repro_torch.core.engine.run`,
:func:`~repro_torch.core.batch.batched_run`, ``DistributedSimulation.run``)
bit for bit, whichever branches the run takes.  The rules:

* **The host count.**  The counters are read once, at the start of a run
  (``state.step``; a batch's (B,) counters, ``active`` and ``stop_step`` in
  one read; the ranks' common counter), and the runner advances them on
  the host, so it knows each step's live sessions and firings without a
  device read.  The frequency gates read that count; the ops see the device
  counter (each rank its own).  A batch's run stops once no session is
  live, as the eager loop does.
* **Keys.**  A step's key is its firing pattern — which ops of frequency
  > 1 (sort, diffusion, health, custom ops) and which gated observables
  (k > 1) fire; in a batch, the tuple of live sessions and each op's and
  observable's firing a session — and its branches (a distributed step's:
  every rank's, each under its ``rank{r}/`` scope, and the overlapped
  schedule's two force passes a rank each under its own).  A graph is
  captured after an eager step with that key: that step is its warm-up (it
  builds the kernels, creates their lazy scratch and the kept constants:
  the grid's and a batch's masks), run on the runner's stream.
* **Layouts.**  A runner keeps its graphs, static buffers and observable
  buffers per layout of the state (its leaves' shapes and dtypes: a batch's
  width is one), up to :data:`LAYOUTS` of them, so batches of different
  widths reuse their own graphs without evicting each other.  The graphs of
  a layout share one memory pool; each ends by copying every state leaf, in
  the checkpoint's order, into the layout's static buffers, so nothing
  stays live in the pool between replays.  A distributed run's buffers are
  the stacked ``DistState`` (the checkpoint's layout); each rank steps on
  views of its rows, and the new state is committed by one ``stack`` a
  leaf into them (a leaf every rank left as its view is skipped; a source
  that shares memory with a buffer is copied aside first).  One graph holds
  the step of every rank.
* **A process mesh** (one process a rank, ``launch.mesh.ProcessMesh``):
  the buffers hold this process's rank, copied from its rows of the stacked
  input.  A step is captured as *segments*, CUDA graphs of one pool cut at
  every shift and gather (``launch.mesh.cutting``): the value is packed in
  the segment, every lane joins the capture stream, and the exchange is
  kept with fixed buffers; a replay runs each segment, then its exchange
  from the host (staging through pinned memory under gloo), in capture
  order.  Nothing is sent during a capture, so processes that capture
  different keys at one step do not wait on each other.  As the eager loop,
  a step gathers the stacked state only where an observable fires (a gather
  entry, whose rows the next segment records), and the run's end gathers it
  once.  The processes agree in one all-reduce each on a warm start, on
  each chunk's length (the fewest steps any can replay: where one lacks its
  graph, all step eagerly there) and on a divergence (all roll back), so
  every process runs the same exchanges in the same order.
* **Speculation with rollback** (the counterpart of ``lax.cond``).  A
  replay takes the branches of the last eager step (``forces.Branches``: a
  bool a predicate, in a batch one a session): it computes the force pass's
  predicates on the device and sets a device ``diverged`` flag where one
  (of a live session) differs from its assumed branch (a distributed step:
  in its rank's own slot of the flag, reduced once the ranks' lanes have
  joined the runner's stream, and on a process mesh over the processes).
  The runner copies the state aside at the start of each chunk of at most
  :data:`CHUNK` replays and reads ``diverged`` once at its end; if it is
  set, the runner restores the copy and runs the chunk eagerly, each step
  reading its predicates itself (and raising the eager ``ValueError`` on a
  negative cell id at the same step).  Later steps replay the graphs keyed
  by the last eager step's branches.  A step after a divergence is thrown away; every
  kernel on the path stays in bounds on such a state.
* **Warm starts.**  A run whose first step's key has a graph, under the
  branches its layout's last run ended with, starts with a replay (the
  rollback covers a wrong guess); its observable buffers are reused when
  they hold the run's rows.  So the chunks of a serving loop or of a
  checkpointed run replay from their first step.
* **Observables** are written inside the graph at device rows:
  frequency-1 ones and ``collect`` at row ``step − start`` of an
  ``(n_steps, …)`` buffer, gated ones at their firing's row of a ``⌈n/k⌉``
  buffer (a distributed run's from the committed stacked state, and only
  the firings returned, as the eager lock-step loop returns them).  A
  batch's buffers are ``(B, rows, …)``: each firing session writes its own
  row, from its own counter and start, so misaligned sessions stay exact,
  and the ``counts`` come from the host's tally.
* **No hidden fallback.**  On the card a failed capture raises: an op, an
  observable or ``fold_rng`` that reads the device while the step is
  captured raises ``ValueError`` naming it (``schedule.CaptureError``).  The
  only eager steps are the warm-up of each new key, the rolled-back chunks
  and the first step of a run that cannot start warm, and on a process mesh
  a step whose graph a peer lacks; :attr:`Runner.stats` counts them
  (``eager_steps`` = ``runs`` − ``warm_starts`` + ``missing_steps`` +
  ``peer_steps`` + ``rolled_back_steps``), with the graphs' ``segments``
  and the replayed ``exchanges``.
* **Spans and counters** (``core/spans.py``).  While ``torch.profiler``
  records, every read is a ``runner.read`` span and every replay a
  ``runner.replay`` span, and the ops and observables of an eager step or a
  capture their own spans.
  :attr:`Runner.stats` adds ``reads`` and ``read_s`` (the device-to-host
  reads of the runs and the host seconds blocked in them: the host count,
  each chunk's flag, and a caller's :meth:`Runner.read_step`) and
  ``replay_s`` (the host seconds inside the replays); a batched runner's,
  ``stacks`` and ``stack_s`` (its ``BatchedSimulation.stack`` calls and
  their host seconds).  A solo or batched
  runner keeps each graph's op map (``spans.mapping``: its kernel, memset
  and memcpy nodes by op, observable and ``record``, taken at the capture),
  and under the profiler enqueues a marker kernel before each replay and
  logs the op map (``spans.mark_replay``), and one after a chunk's last
  replay (``spans.close_replays``), so that a reader of the trace can give
  each replay's device events to its ops.
* **Launch counters.**  A kernel wrapper counts its launch when its Python
  runs, which for a captured kernel is at the capture: the runner takes
  each graph's count back after capture and adds it again at each replay.
  The replays a rollback throws away did launch their kernels: their
  launches are also kept in :attr:`Runner.rolled_back_launches`, so the
  counters less those equal the eager run's.
* **On the CPU** there is no graph: the caller asked for the CPU, and the
  same runner calls each captured body as a plain function, so the host
  count, the keys, the flags, the speculation and the rollback run (and
  are tested) there too.

Limits: the state's tree, shapes and static fields must not change over a
run; custom ops and observables must not read the device or copy host
values to it (a ``torch.tensor(...)`` on the card inside the step is such
a copy, and so is a Python scalar written through an index tensor,
``x[idx] = True``: ``index_fill_`` fills on the device); an in-process
distributed run needs every rank on one device (a mesh over several cards
raises ``ValueError``; ROADMAP item 17), a process mesh one device a
process.  The ranks run on their own lanes (``core/lanes.py``): one stream
a rank, and in the overlapped schedule a second beside it for the halo
exchange, each forked from the runner's stream and joined back within the
step (and at each cut of a process mesh's step), so a graph holds a branch
a lane.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..checkpoint.checkpoint import _leaves_with_paths, _map_with_paths
from .forces import Branches
from .grid import bool_mask, device_constant
from . import spans
from .schedule import Scheduler
from .slots import select, to_flat, to_slots
from .spans import span

# Replays between two reads of the divergence flag: the most steps a
# divergence rolls back and runs eagerly, and one device-to-host read (and
# one copy of the state) every CHUNK steps.
CHUNK = 32

# Layouts of the state a runner keeps graphs and buffers for (the least
# recently run is dropped beyond it).
LAYOUTS = 4

# Runs in progress (``engine.derive_n_kinds`` refuses to derive inside one).
_running = 0


def running() -> bool:
    """Is a compiled run in progress?"""
    return _running > 0


def _skeleton(tree) -> tuple:
    """The tree's leaves as ``(path, shape, dtype)``: what the static
    buffers and the captured graphs were made for."""
    out = []
    for path, x in _leaves_with_paths(tree):
        if not torch.is_tensor(x):
            raise TypeError(f"run_jit: state leaf {path} is a {type(x).__name__}, "
                            f"not a tensor")
        out.append((path, tuple(x.shape), x.dtype))
    return tuple(out)


def _tensors(tree):
    """The tensors of a tensor or a dict of them (``collect``'s output)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        return next(it)
    return put(tree)


def _multiples(lo: int, hi: int, k: int) -> int:
    """How many counts in ``[lo, hi)`` are ≡ 0 (mod k)."""
    return (hi - 1) // k - (lo - 1) // k


class _Layout:
    """What a runner keeps for one layout of the state: its static buffers
    (the state the graphs read and write; a distributed run's are the
    stacked state, with ``ranks`` the views of each rank's rows), the
    chunk's saved copy, the device flag and run starts, the graphs and their
    pool, the observable buffers, and the branches its last run ended
    with."""

    def __init__(self, key: tuple, state, counter: torch.Tensor, device: torch.device,
                 mesh=None):
        self.key, self.device = key, device
        self.static = _map_with_paths(
            state, lambda p, x: torch.empty(x.shape, dtype=x.dtype, device=device))
        self.leaves = [x for _, x in _leaves_with_paths(self.static)]
        if mesh is not None and not mesh.process:
            from .distributed import unstack_state

            self.ranks = unstack_state(self.static, mesh.devices)
            self.rank_key = _skeleton(self.ranks[0])
        self.saved = [torch.empty_like(x) for x in self.leaves]
        self.ptrs = {x.untyped_storage().data_ptr() for x in self.leaves}
        # A distributed run's flag has a slot a rank (forces.Branches.scoped).
        self.diverged = torch.zeros((len(mesh.local_ranks),) if mesh is not None else (),
                                    dtype=torch.bool, device=device)
        self.start = torch.zeros(counter.shape, dtype=torch.int32, device=device)
        self.graphs: Dict[tuple, object] = {}
        # Each graph's op map (``spans.mapping``), by key; a distributed
        # run's graphs have none.
        self.op_maps: Dict[tuple, Optional[tuple]] = {}
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.obs_sig = None
        self.bufs: Dict[str, object] = {}
        self.protos: Optional[Dict[str, object]] = None
        self.branches: Optional[tuple] = None
        # A process mesh's exchange buffers (``launch.mesh.Exchange.place``).
        self.wires: Dict[tuple, tuple] = {}

    def drop_graphs(self):
        self.graphs, self.op_maps = {}, {}
        if self.pool is not None:
            self.pool = torch.cuda.graph_pool_handle()


class _Segments:
    """A process mesh's captured step: its CUDA graphs (one pool), each but
    the last followed by the exchange cut there (``launch.mesh.Exchange``);
    the ``(rank, axis, nbytes)`` of its shifts, reported to
    ``count_shift_bytes`` at each replay, and its shifts' lane records
    (``lanes.observe``)."""

    def __init__(self):
        self.graphs: list = []
        self.exchanges: list = []
        self.shifted: list = []
        self.tags: list = []

    def replay(self) -> None:
        from ..launch.mesh import shift_observers
        from . import lanes

        for j, graph in enumerate(self.graphs):
            graph.replay()
            if j < len(self.exchanges):
                self.exchanges[j].run()
        for rank, axis, nbytes in self.shifted:
            for observe in shift_observers:
                observe(rank, axis, nbytes)
        for seen in lanes._observers:
            seen.shifts.extend(self.tags)


class Runner:
    """A reusable compiled runner for one (config, scheduler): holds its
    graphs, static buffers and memory pools, per layout of the state.
    ``runner(state, n_steps, collect=None, observables=None)`` returns what
    ``engine.run(config, state, n_steps, ...)`` returns; with
    ``batched=True``, ``runner(bstate, n_steps, observables=None)`` returns
    what ``batch.batched_run(config, bstate, n_steps, ...)`` returns; with
    a ``mesh`` (the distributed step's scheduler; an in-process mesh with
    every rank on one device, or a process mesh),
    ``runner(state, n_steps, observables=None)`` steps the stacked
    ``DistState`` and returns what ``DistributedSimulation.run`` returns."""

    def __init__(self, config, scheduler: Optional[Scheduler] = None,
                 batched: bool = False, mesh=None):
        if batched and mesh is not None:
            raise ValueError("a runner is batched or distributed, not both")
        self.config = config
        self.scheduler = scheduler or Scheduler.default(config)
        self.batched = batched
        self.mesh = mesh
        self._process = mesh is not None and mesh.process
        self.stats = {"runs": 0, "warm_starts": 0, "graphs": 0, "segments": 0, "replays": 0,
                      "exchanges": 0, "eager_steps": 0, "missing_steps": 0,
                      "peer_steps": 0, "rollbacks": 0, "rolled_back_steps": 0,
                      "capture_s": 0.0, "replay_s": 0.0, "reads": 0, "read_s": 0.0}
        if batched:
            # ``BatchedSimulation.stack``'s calls and host seconds.
            self.stats.update(stacks=0, stack_s=0.0)
        self._gates = tuple(op for op in self.scheduler.ordered_ops() if op.frequency > 1)
        # Launches of the replays thrown away by rollbacks, by kernel: the
        # launch counters less these are the eager run's.
        self.rolled_back_launches: collections.Counter = collections.Counter()
        self._layouts: "collections.OrderedDict[tuple, _Layout]" = collections.OrderedDict()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    @property
    def _graphs(self) -> dict:
        """Every kept layout's graphs, by key."""
        return {k: g for lay in self._layouts.values() for k, g in lay.graphs.items()}

    # -- the host count ---------------------------------------------------------

    def _counter(self, state) -> torch.Tensor:
        return state.states.step if self.batched else state.step

    def _timed_read(self, read: Callable):
        """``read()``, a device-to-host read, counted in ``stats["reads"]``
        and its host seconds in ``stats["read_s"]``."""
        with span("runner.read"):
            t0 = time.perf_counter()
            out = read()
            self.stats["read_s"] += time.perf_counter() - t0
        self.stats["reads"] += 1
        return out

    def read_step(self, state) -> int:
        """``int(state.step)`` for the caller of the next run, as a timed
        read of that run."""
        return self._timed_read(lambda: int(state.step))

    def _read(self, state):
        """The host count: ``state.step`` (the ranks' common counter; a
        batch's counters, with its ``active`` and ``stop_step`` kept for
        :meth:`_live`), in one read."""
        if self.mesh is not None:
            return self._timed_read(lambda: int(state.step.reshape(-1)[0]))
        if not self.batched:
            return self._timed_read(lambda: int(state.step))
        steps, active, stop = self._timed_read(lambda: torch.stack([
            state.states.step.to(torch.int64), state.active.to(torch.int64),
            state.stop_step.to(torch.int64)]).tolist())
        self._active, self._stop = tuple(bool(a) for a in active), tuple(stop)
        return tuple(steps)

    def _live(self, host):
        """A batch's live sessions at the host count (None solo)."""
        if not self.batched:
            return None
        return tuple(a and s < t for a, s, t in zip(self._active, host, self._stop))

    def _any_live(self, host) -> bool:
        return not self.batched or any(self._live(host))

    def _advance(self, host):
        if not self.batched:
            return host + 1
        return tuple(s + 1 if l else s for s, l in zip(host, self._live(host)))

    def _firing(self, host, live, k: int):
        """Do observables of frequency ``k`` fire: a bool (solo), or the
        tuple of firing sessions."""
        if live is None:
            return host % k == 0
        return tuple(b for b, (l, s) in enumerate(zip(live, host)) if l and s % k == 0)

    def _pattern(self, host) -> tuple:
        live = self._live(host)
        if live is None:
            return (tuple(host % op.frequency == 0 for op in self._gates)
                    + tuple(host % k == 0 for _, _, k in self._gated))
        fires = lambda f: tuple(l and s % f == 0 for l, s in zip(live, host))
        return ((live,) + tuple(fires(op.frequency) for op in self._gates)
                + tuple(fires(k) for _, _, k in self._gated))

    # -- set-up ---------------------------------------------------------------

    def _layout(self, state) -> _Layout:
        """The layout's buffers and graphs (made at its first run; the least
        recently run of more than :data:`LAYOUTS` dropped), the state copied
        in."""
        if self._process:
            # This process's rank, from the stacked state wherever it lies.
            from .slots import tree_map

            state = tree_map(lambda x: x[self.mesh.rank], state)
        counter = self._counter(state)
        device = self.mesh.device if self._process else counter.device
        if self.mesh is not None and device != self.mesh.devices[0]:
            raise ValueError(f"run_jit: the state lies on {counter.device}, the mesh's "
                             f"ranks on {self.mesh.devices[0]}")
        key = (device, _skeleton(state))
        lay = self._layouts.get(key)
        if lay is None:
            lay = self._layouts[key] = _Layout(key, state, counter, device, self.mesh)
            while len(self._layouts) > LAYOUTS:
                self._layouts.popitem(last=False)
        self._layouts.move_to_end(key)
        if lay.device.type == "cuda" and lay.device not in self._streams:
            self._streams[lay.device] = torch.cuda.Stream(lay.device)
        for dst, (_, src) in zip(lay.leaves, _leaves_with_paths(state)):
            dst.copy_(src)
        return lay

    @contextlib.contextmanager
    def _on_stream(self, lay: _Layout):
        """Run on the runner's stream, after the caller's work and before
        the caller's next."""
        stream = self._streams.get(lay.device)
        if stream is None:
            yield
            return
        caller = torch.cuda.current_stream(lay.device)
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            caller.wait_stream(stream)

    def _lead(self, rows: int) -> tuple:
        return (rows,) if not self.batched else (self._width, rows)

    def _ensure_buffers(self, lay: _Layout, protos: Dict[str, object]):
        """The observable buffers, zeroed: ``self._rows[name]`` rows of each
        proto's shape and dtype (made anew, and the graphs dropped, when one
        does not fit)."""
        rows, d = self._rows, len(self._lead(0)) - 1
        fits = set(lay.bufs) == set(protos) and all(
            [(tuple(b.shape[d + 1:]), b.dtype) for b in _tensors(lay.bufs[n])]
            == [(tuple(p.shape), p.dtype) for p in _tensors(protos[n])]
            and _tensors(lay.bufs[n])[0].shape[d] >= rows[n]
            for n in protos)
        if not fits:
            lay.drop_graphs()
            lay.bufs = {
                n: _rebuild(p, [torch.empty(self._lead(rows[n]) + tuple(t.shape),
                                            dtype=t.dtype, device=lay.device)
                                for t in _tensors(p)])
                for n, p in protos.items()}
            lay.protos = {n: _rebuild(p, [t.to("meta") for t in _tensors(p)])
                          for n, p in protos.items()}
        for b in lay.bufs.values():
            for t in _tensors(b):
                t.zero_()

    def _ready(self, lay: _Layout, sig) -> bool:
        """Are the observable buffers known for this run (so its first step
        may be a replay)?  Sizes them from the layout's last run's protos."""
        if sig != lay.obs_sig:
            lay.obs_sig, lay.bufs, lay.protos = sig, {}, None
            lay.drop_graphs()
        if not self._rows:
            return True
        if lay.protos is None:
            return False
        self._ensure_buffers(lay, lay.protos)
        return True

    def _fill_start(self, lay: _Layout, host):
        """The run's start counters, on the device."""
        if self.batched:
            lay.start.copy_(lay.static.states.step)
        else:
            lay.start.fill_(host)

    # -- one step -------------------------------------------------------------

    def _values(self, new, host, live, protos: bool = False):
        """The rows this step records, by name, and with ``protos`` every
        observable's value (for the buffers' shapes).  A batch's record is
        ``(sessions, stacked values)`` of its firing sessions."""
        record, every = {}, {}
        if live is not None:
            from .batch import _observe

            for name, fn, k in self._obs:
                slots = self._firing(host, live, k)
                if not slots and not protos:
                    continue
                with span(f"observe.{name}"):
                    rows = _observe(fn, new.states, slots or (0,))
                value = torch.stack([rows[b] for b in slots or (0,)])
                every[name] = value[0]
                if slots:
                    record[name] = (slots, value)
            return record, every
        if self._collect is not None:
            with span("observe.collect"):
                record["collect"] = self._collect(new)
        for name, fn, k in self._obs:
            if protos or host % k == 0:
                with span(f"observe.{name}"):
                    every[name] = fn(new)
                if host % k == 0:
                    record[name] = every[name]
        every.update(record)
        return record, every

    def _record(self, lay: _Layout, values: Dict[str, object], i=None):
        """Write this step's rows: device indices from the pre-step counter
        (the static one, not yet overwritten, unless ``i`` gives its offset
        from the start)."""
        if not values:
            return
        if i is None:
            i = self._counter(lay.static) - lay.start
        for name, value in values.items():
            k = self._every.get(name, 1)
            # At a firing, i = o + j·k with o = (−start) mod k < k: the row j is ⌊i/k⌋.
            row = i if k == 1 else torch.div(i, k, rounding_mode="floor")
            if self.batched:
                slots, value = value
                idx = device_constant(("sessions", slots), lay.device,
                                      lambda: torch.tensor(slots, dtype=torch.long))
                buf = lay.bufs[name]
                buf.index_put_((idx, row.index_select(0, idx).long()), value.to(buf.dtype))
                continue
            row = row.reshape(1).long()
            for buf, v in zip(_tensors(lay.bufs[name]), _tensors(value)):
                buf.index_copy_(0, row, v.reshape((1,) + tuple(v.shape)).to(buf.dtype))

    def _commit(self, lay: _Layout, new):
        """Copy the new state's leaves into the static buffers.  A leaf that
        is the buffer itself, or a view of all of it, is left; one that
        shares memory with a buffer otherwise is copied aside first."""
        if _skeleton(new) != lay.key[1]:
            raise ValueError("run_jit: the step changed the state's tree, shapes, "
                             "dtypes or static fields; the compiled run needs them fixed")
        leaves = [x for _, x in _leaves_with_paths(new)]
        same = lambda s, d: s is d or (s.data_ptr() == d.data_ptr()
                                       and s.stride() == d.stride())
        srcs = [None if same(s, d) else
                s.clone() if s.untyped_storage().data_ptr() in lay.ptrs else s
                for s, d in zip(leaves, lay.leaves)]
        for s, d in zip(srcs, lay.leaves):
            if s is not None:
                d.copy_(s)

    def _commit_ranks(self, lay: _Layout, ranks):
        """Write each rank's new state into its rows of the stacked static
        buffers, one stack a leaf.  A leaf every rank left as its own view is
        left; a source that shares memory with a buffer is copied aside
        first."""
        news = []
        for new in ranks:
            if _skeleton(new) != lay.rank_key:
                raise ValueError("run_jit: the step changed a rank's tree, shapes, dtypes "
                                 "or static fields; the compiled run needs them fixed")
            news.append([x for _, x in _leaves_with_paths(new)])
        olds = [[x for _, x in _leaves_with_paths(view)] for view in lay.ranks]
        same = lambda s, d: s is d or (s.data_ptr() == d.data_ptr()
                                       and s.stride() == d.stride())
        writes = []
        for j, buf in enumerate(lay.leaves):
            srcs = [new[j] for new in news]
            if all(same(s, old[j]) for s, old in zip(srcs, olds)):
                continue
            writes.append((buf, [s.clone() if s.untyped_storage().data_ptr() in lay.ptrs
                                 else s for s in srcs]))
        for buf, srcs in writes:
            torch.stack(srcs, out=buf)

    def _dist_step(self, lay: _Layout, host, branches: Branches, protos: bool = False):
        """One lock-step step of every rank from the stacked static buffers,
        committed into them; returns the rows it records (observed on the
        committed stacked state), every observable's value with ``protos``,
        and the rows' offset from the start (taken before the commit).  On
        a process mesh the buffers hold this process's rank, and the stacked
        state is gathered only at a step where an observable fires, as the
        eager loop gathers it (the buffers were made from the run's input)."""
        from .distributed import step_ranks

        if self._process:
            i = lay.static.step - lay.start if self._rows else None
            self._commit(lay, step_ranks(self.mesh, self.scheduler, [lay.static], host,
                                         branches=branches)[0])
            if not any(host % k == 0 for _, _, k in self._obs):
                return {}, {}, i
            record, every = self._values(self.mesh.all_gather(lay.static), host, None)
            return record, every, i
        i = lay.static.step[:1] - lay.start[:1] if self._rows else None
        self._commit_ranks(lay, step_ranks(self.mesh, self.scheduler, lay.ranks, host,
                                           branches=branches))
        record, every = self._values(lay.static, host, None, protos)
        return record, every, i

    def _body(self, lay: _Layout, host, live, branches: Branches, protos: bool = False):
        """One step from the static buffers: the new state, and the rows it
        records (:meth:`_values`)."""
        static = lay.static
        if live is None:
            new = self.scheduler.step_at(static, host, branches=branches)
            return new, self._values(new, host, None, protos)
        stepped = to_slots(self.scheduler.step_slots(to_flat(static.states), live, host,
                                                     branches=branches))
        if not all(live):
            stepped = select(static.live(), stepped, static.states)
        new = dataclasses.replace(static, states=stepped)
        return new, self._values(new, host, live, protos)

    def _step(self, lay: _Layout, host, live, branches: Branches, first: bool = False):
        """One step from the static buffers: its rows recorded, its new state
        committed; with ``first`` the observable buffers are made from its
        values first."""
        i = None
        if self.mesh is not None:
            record, every, i = self._dist_step(lay, host, branches, protos=first)
        else:
            new, (record, every) = self._body(lay, host, live, branches, protos=first)
        if first:
            self._ensure_buffers(lay, every)
        self._record(lay, record, i)
        if self.mesh is None:
            self._commit(lay, new)

    def _eager(self, lay: _Layout, host, first: bool = False) -> tuple:
        """One eager step (recording its branches; with ``first``, making
        the observable buffers from its values); captures the graph of its
        key if there is none yet.  Returns the branches taken."""
        branches = Branches()
        live = self._live(host)
        if lay.pool is not None and self.mesh is None and spans.enabled():
            spans.log_eager()
        self._step(lay, host, live, branches, first)
        self.stats["eager_steps"] += 1
        key = (self._pattern(host), branches.key())
        if key not in lay.graphs:
            self._capture(lay, key, host, live)
        return branches.key()

    # -- graphs ---------------------------------------------------------------

    def _capture(self, lay: _Layout, key: tuple, host, live):
        """Capture the step of ``key`` into the layout's pool.  A
        distributed step's lanes join the capture: each forks from the
        capture stream and joins it again before the step returns
        (``distributed.step_ranks``), so the graph holds a branch a rank's
        lane, side by side, and their allocations land in the pool too."""
        assumed = dict(key[1])
        body = lambda: self._step(lay, host, live, Branches(assumed, lay.diverged))
        self.stats["graphs"] += 1
        if lay.pool is None:
            lay.graphs[key] = body
            return
        from repro_torch import kernels

        if live is not None:
            # The masks an assuming batch step compares its predicates with.
            for values in (live,) + tuple(assumed.values()):
                bool_mask(values, lay.device)
        t0 = time.perf_counter()
        before = kernels.read_launches()
        if self._process:
            graph = self._capture_segments(lay, body)
        else:
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=lay.pool)
            try:
                if self.mesh is None:
                    with spans.mapping(spans.GraphNodes()) as op_map:
                        body()
                    lay.op_maps[key] = (None if op_map.entries is None
                                        else tuple(op_map.entries))
                else:
                    body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
            self.stats["segments"] += 1
        after = kernels.read_launches()
        kernels.add_launches({n: before[n] - after[n] for n in after})
        lay.graphs[key] = (graph, {n: after[n] - before[n] for n in after})
        self.stats["capture_s"] += time.perf_counter() - t0

    def _capture_segments(self, lay: _Layout, body) -> "_Segments":
        """Capture a process mesh's step as segments cut at each exchange:
        a shift or gather packs its value in the segment being captured;
        there every lane joins the capture stream, the segment ends, the
        exchange takes its fixed buffers, and the next segment begins with
        the lanes forked again (``lanes.rejoined``).  Nothing is sent: the
        exchanges run at each replay, between their segments."""
        from ..launch import mesh as mesh_mod
        from . import lanes

        stream = self._streams[lay.device]
        segs = _Segments()

        def begin():
            segs.graphs.append(torch.cuda.CUDAGraph())
            segs.graphs[-1].capture_begin(pool=lay.pool)

        def cut(exchange):
            def between():
                with torch.cuda.stream(stream):
                    segs.graphs[-1].capture_end()
                    exchange.place(lay.wires, len(segs.exchanges))
                    segs.exchanges.append(exchange)
                    begin()
            lanes.rejoined(between)

        begin()
        try:
            with lanes.withheld() as seen, mesh_mod.cutting(cut) as cutting:
                body()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                segs.graphs[-1].capture_end()
            raise
        segs.graphs[-1].capture_end()
        segs.shifted, segs.tags = cutting.shifted, seen.shifts
        self.stats["segments"] += len(segs.graphs)
        return segs

    def _replay(self, lay: _Layout, key: tuple) -> dict:
        """Replay the graph of ``key`` (a process mesh's: its segments, each
        followed by its exchange); returns its launches, by kernel.  Under
        the profiler a graph of a solo or batched runner is preceded by the
        marker kernel, and its op map logged (``spans.mark_replay``)."""
        from repro_torch import kernels

        entry = lay.graphs[key]
        if callable(entry):
            before = kernels.read_launches()
            sent = self.mesh.stats.exchanges if self._process else 0
            self._timed_replay(entry)
            if self._process:
                self.stats["exchanges"] += self.mesh.stats.exchanges - sent
            after = kernels.read_launches()
            launches = {n: after[n] - before[n] for n in after}
        else:
            graph, launches = entry
            if self.mesh is None and spans.enabled():
                spans.mark_replay(lay.op_maps.get(key))
            self._timed_replay(graph.replay)
            if isinstance(graph, _Segments):
                self.stats["exchanges"] += len(graph.exchanges)
            kernels.add_launches(launches)
        self.stats["replays"] += 1
        return launches

    def _timed_replay(self, replay: Callable) -> None:
        """``replay()``, its host seconds in ``stats["replay_s"]``."""
        with span("runner.replay"):
            t0 = time.perf_counter()
            replay()
            self.stats["replay_s"] += time.perf_counter() - t0

    # -- the run --------------------------------------------------------------

    def __call__(self, state, n_steps: int, collect: Optional[Callable] = None,
                 observables: Optional[Tuple[Tuple[str, Callable, int], ...]] = None):
        global _running
        if collect is not None and (observables or self.batched or self.mesh is not None):
            raise ValueError("pass either collect= or observables=, not both"
                             if observables else "a batch's or a distributed run takes "
                             "observables=")
        obs = tuple(observables or ())
        names = [n for n, _, _ in obs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate observable names in {names}")
        n = int(n_steps)
        if not spans.enabled():
            spans.unprofiled_run()
        self._collect = collect
        self._obs = tuple((name, f, k) for name, f, k in obs if k > 0)
        self._gated = tuple((name, f, k) for name, f, k in self._obs if k > 1)
        self._every = {name: k for name, _, k in self._obs}
        self._rows = {name: -(-max(n, 0) // k) for name, _, k in self._obs}
        if collect is not None:
            self._rows["collect"] = n
        _running += 1
        try:
            host = self._read(state)
            if self.batched:
                self._width = len(host)
            if n <= 0 or not self._any_live(host):
                return self._empty(state, n)
            self.stats["runs"] += 1
            if self._process:
                # The buffers' protos, from the stacked input (the eager loop
                # gathers only where an observable fires).
                self._protos = {name: fn(state) for name, fn, _ in self._obs}
            lay = self._layout(state)
            with self._on_stream(lay):
                self._fill_start(lay, host)
                end = self._drive(lay, host, n)
                if self._process:
                    final = self.mesh.all_gather(lay.static)
            if not self._process:
                final = _map_with_paths(lay.static, lambda p, x: x.clone())
            return self._outs(lay, final, n, host, end)
        finally:
            _running -= 1

    def _drive(self, lay: _Layout, host, n: int):
        """``n`` steps from the host count ``host`` (fewer once no session
        is live); returns the host count at the end.

        On a process mesh every process must run the same exchanges in the
        same order, so the processes agree, each in one all-reduce, on a
        warm start, on each chunk's length (the fewest steps any process can
        replay from its start: where one lacks its graph every process ends
        the chunk and steps eagerly) and on a divergence."""
        sig = (self._collect, self._obs)
        branches, i = lay.branches, 0
        ready = self._ready(lay, sig)
        if self._process and not ready:
            self._ensure_buffers(lay, self._protos)
            ready = True
        warm = (ready and branches is not None
                and (self._pattern(host), branches) in lay.graphs)
        if self._process:
            warm = not self.mesh.all_max([not warm])[0]
        if warm:
            self.stats["warm_starts"] += 1
        else:
            branches = self._eager(lay, host, first=not self._process)
            host, i = self._advance(host), 1
        while i < n and self._any_live(host):
            first, first_host = i, host
            agreed = None
            if self._process:
                agreed = -self.mesh.all_max([-self._replayable(lay, host, branches,
                                                               min(n - i, CHUNK))])[0]
            missing, launched = False, collections.Counter()
            while i < n and self._any_live(host) and i - first < CHUNK:
                key = (self._pattern(host), branches)
                if key not in lay.graphs or (agreed is not None and i - first >= agreed):
                    missing = True
                    break
                if i == first:
                    for s, d in zip(lay.leaves, lay.saved):
                        d.copy_(s)
                    lay.diverged.zero_()
                launched.update(self._replay(lay, key))
                host, i = self._advance(host), i + 1
            if i > first and lay.pool is not None and self.mesh is None and spans.enabled():
                spans.close_replays()
            if i > first and self._diverged(lay):
                for s, d in zip(lay.saved, lay.leaves):
                    d.copy_(s)
                self.stats["rollbacks"] += 1
                self.stats["rolled_back_steps"] += i - first
                self.rolled_back_launches.update(launched)
                host = first_host
                for _ in range(first, i):
                    branches = self._eager(lay, host)
                    host = self._advance(host)
                continue
            if missing:
                own = (self._pattern(host), branches) in lay.graphs
                self.stats["peer_steps" if own else "missing_steps"] += 1
                branches = self._eager(lay, host)
                host, i = self._advance(host), i + 1
        lay.branches = branches
        return host

    def _replayable(self, lay: _Layout, host, branches, most: int) -> int:
        """How many steps from ``host`` (at most ``most``) have a graph under
        ``branches``."""
        for j in range(most):
            if (self._pattern(host), branches) not in lay.graphs:
                return j
            host = self._advance(host)
        return most

    def _diverged(self, lay: _Layout) -> bool:
        """Did a replay of the chunk diverge?  One read of the flag, its
        rank slots reduced first on the runner's stream, after every rank's
        lane has joined it; on a process mesh, then reduced over the
        processes, so that all roll the chunk back together."""
        diverged = self._timed_read(lambda: bool(lay.diverged.any()))
        if self._process:
            return bool(self.mesh.all_max([diverged])[0])
        return diverged

    def _outs(self, lay: _Layout, final, n: int, start, end):
        bufs = lay.bufs
        if self.mesh is not None:
            # The eager lock-step run's rows: each observable's firings only.
            return final, {name: bufs[name][:_multiples(start, end, k)].clone()
                           for name, _, k in self._obs}
        if self.batched:
            dev = lay.device
            obs = {name: bufs[name][:, :rows].clone() for name, rows in self._rows.items()}
            counts = {name: torch.tensor([_multiples(a, b, k) for a, b in zip(start, end)],
                                         dtype=torch.int32, device=dev)
                      for name, _, k in self._obs}
            return final, obs, counts
        if self._collect is not None:
            buf = bufs["collect"]
            return final, _rebuild(buf, [t[:n].clone() for t in _tensors(buf)])
        if not self._rows:
            return final, torch.zeros((n,), dtype=torch.int32, device=final.pool.device)
        return final, {name: bufs[name][:rows].clone() for name, rows in self._rows.items()}

    def _empty(self, state, n: int):
        """A run of no steps (or, in a batch, with no live session): the
        eager run's result, which steps nothing either."""
        if self.batched:
            from .batch import batched_run

            return batched_run(self.config, state, n, self.scheduler,
                               observables=self._obs or None)
        if self.mesh is not None:
            protos = {name: fn(state) for name, fn, _ in self._obs}
            return state, {name: torch.zeros((0,) + tuple(p.shape), dtype=p.dtype,
                                             device=p.device) for name, p in protos.items()}
        from .engine import run

        return run(self.config, state, max(n, 0), collect=self._collect,
                   scheduler=self.scheduler, observables=self._obs or None)
