"""Compiled execution: the engine step replayed from CUDA graphs.

The counterpart of the reference's ``jax.jit`` over the ``lax.scan`` of the
step (``repro.core.engine.run_jit``): a :class:`Runner` captures the step of
one (config, scheduler) in ``torch.cuda.CUDAGraph``s and replays them, and
its results are the eager :func:`~repro_torch.core.engine.run`'s bit for
bit, whichever branches the run takes.  The rules:

* **The host count.**  ``state.step`` is read once, at the start of a run;
  the runner advances the count on the host.  The frequency gates read it
  (``Scheduler.step_at``); the ops see the device counter.
* **Firing patterns.**  A pattern is which ops of frequency > 1 (sort,
  diffusion, health, custom ops) and which gated observables (k > 1) fire
  at a count.  A graph is keyed by (pattern, branches) and captured after an
  eager step that had that pattern and took those branches: that step is
  its warm-up (it builds the kernels, creates their lazy scratch and the
  grid's constants), run on the runner's stream.  All graphs share one
  memory pool; each ends by copying every state leaf, in the checkpoint's
  order, into the runner's static buffers, so nothing stays live in the
  pool between replays.
* **Speculation with rollback** (the counterpart of ``lax.cond``).  A
  replay takes the branches of the last eager step (``forces.Branches``):
  it computes the force pass's predicates on the device and sets a device
  ``diverged`` flag where one differs from its assumed branch.  The runner
  copies the state aside at the start of each chunk of at most
  :data:`CHUNK` replays and reads ``diverged`` once at its end; if it is
  set, the runner restores the copy and runs the chunk eagerly, each step
  reading its predicates itself (and raising the eager ``ValueError`` on a
  negative cell id at the same step).  Later steps replay the graphs keyed
  by the last eager step's branches.  A step after a divergence is thrown
  away; every kernel on the path stays in bounds on such a state.
* **Observables** are written inside the graph: frequency-1 ones and
  ``collect`` at row ``step − start`` of an ``(n_steps, …)`` buffer, gated
  ones at their firing's row of a ``⌈n/k⌉`` buffer, both device indices.
* **No hidden fallback.**  On the card a failed capture raises: an op, an
  observable or ``fold_rng`` that reads the device while the step is
  captured raises ``ValueError`` naming it (``schedule.CaptureError``).  The
  only eager steps are the first of each run, the warm-up of each new key
  and the rolled-back chunks; :attr:`Runner.stats` counts them.
* **Launch counters.**  A kernel wrapper counts its launch when its Python
  runs, which for a captured kernel is at the capture: the runner takes
  each graph's count back after capture and adds it again at each replay.
* **On the CPU** there is no graph: the caller asked for the CPU, and the
  same runner calls each captured body as a plain function, so the host
  count, the patterns, the flags, the speculation and the rollback run (and
  are tested) there too.

Limits: the solo engine only (a batch's and the distributed executor's
steps run eagerly); the state's tree, shapes and static fields must not
change over a run; custom ops and observables must not read the device or
copy host values to it (a ``torch.tensor(...)`` on the card inside the step
is such a copy).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..checkpoint.checkpoint import _leaves_with_paths, _map_with_paths
from .forces import Branches
from .schedule import Scheduler, _naming

# Replays between two reads of the divergence flag: the most steps a
# divergence rolls back and runs eagerly, and one device-to-host read (and
# one copy of the state) every CHUNK steps.
CHUNK = 32

# Runs in progress (``engine.derive_n_kinds`` refuses to derive inside one).
_running = 0


def running() -> bool:
    """Is a compiled run in progress?"""
    return _running > 0


def _skeleton(tree):
    """The tree with each leaf replaced by its shape and dtype: what the
    static buffers and the captured graphs were made for."""
    def leaf(path, x):
        if not torch.is_tensor(x):
            raise TypeError(f"run_jit: state leaf {path} is a {type(x).__name__}, "
                            f"not a tensor")
        return tuple(x.shape), x.dtype
    return _map_with_paths(tree, leaf)


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


class Runner:
    """A reusable compiled runner for one (config, scheduler): holds its
    graphs, static buffers and memory pool.  ``runner(state, n_steps,
    collect=None, observables=None)`` returns what
    ``engine.run(config, state, n_steps, ...)`` returns."""

    def __init__(self, config, scheduler: Optional[Scheduler] = None):
        self.config = config
        self.scheduler = scheduler or Scheduler.default(config)
        self.stats = {"graphs": 0, "replays": 0, "eager_steps": 0, "rollbacks": 0,
                      "rolled_back_steps": 0, "capture_s": 0.0}
        self._gates = tuple(op for op in self.scheduler.ordered_ops() if op.frequency > 1)
        self._graphs: Dict[tuple, object] = {}
        self._layout = None
        self._obs_sig = None
        self._bufs: Dict[str, object] = {}
        self._device = None

    # -- set-up ---------------------------------------------------------------

    def _reset_graphs(self):
        self._graphs = {}
        if self._device is not None and self._device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()

    def _prepare(self, state, obs_sig):
        """Static buffers for ``state``'s layout (made anew, and the graphs
        dropped, when it changed), the state copied in."""
        device = state.step.device
        layout = _skeleton(state)
        if device != self._device or layout != self._layout:
            self._device = device
            self._layout = layout
            self._bufs = {}
            self._reset_graphs()
            self._static = _map_with_paths(
                state, lambda p, x: torch.empty(x.shape, dtype=x.dtype, device=device))
            self._leaves = [x for _, x in _leaves_with_paths(self._static)]
            self._saved = [torch.empty_like(x) for x in self._leaves]
            self._ptrs = {x.untyped_storage().data_ptr() for x in self._leaves}
            self._diverged = torch.zeros((), dtype=torch.bool, device=device)
            self._start = torch.zeros((), dtype=torch.int32, device=device)
            self._offsets: Dict[int, torch.Tensor] = {}
            self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        if obs_sig != self._obs_sig:
            self._obs_sig = obs_sig
            self._bufs = {}
            self._reset_graphs()
        for dst, (_, src) in zip(self._leaves, _leaves_with_paths(state)):
            dst.copy_(src)

    @contextlib.contextmanager
    def _on_stream(self):
        """Run on the runner's stream, after the caller's work and before
        the caller's next."""
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            caller.wait_stream(self._stream)

    def _ensure_buffers(self, protos: Dict[str, object], rows: Dict[str, int]):
        """The observable buffers, zeroed: ``rows[name]`` rows of each
        proto's shape and dtype (made anew, and the graphs dropped, when one
        does not fit)."""
        fits = set(self._bufs) == set(protos) and all(
            [(tuple(b.shape[1:]), b.dtype) for b in _tensors(self._bufs[n])]
            == [(tuple(p.shape), p.dtype) for p in _tensors(protos[n])]
            and _tensors(self._bufs[n])[0].shape[0] >= rows[n]
            for n in protos)
        if not fits:
            self._reset_graphs()
            self._bufs = {
                n: _rebuild(p, [torch.empty((rows[n],) + tuple(t.shape), dtype=t.dtype,
                                            device=self._device) for t in _tensors(p)])
                for n, p in protos.items()}
        for b in self._bufs.values():
            for t in _tensors(b):
                t.zero_()

    # -- one step -------------------------------------------------------------

    def _pattern(self, host: int) -> tuple:
        return (tuple(host % op.frequency == 0 for op in self._gates)
                + tuple(host % k == 0 for _, _, k in self._gated))

    def _values(self, new, host: int, protos: bool = False) -> Dict[str, object]:
        """The observables this step records, by name (``protos``: the
        gated ones that do not fire too, for their shapes)."""
        out = {}
        if self._collect is not None:
            with _naming("collect"):
                out["collect"] = self._collect(new)
        for name, fn in self._streamed:
            with _naming(f"observable {name!r}"):
                out[name] = fn(new)
        for name, fn, k in self._gated:
            if protos or host % k == 0:
                with _naming(f"observable {name!r}"):
                    out[name] = fn(new)
        return out

    def _record(self, values: Dict[str, object]):
        """Write this step's rows: device indices from the pre-step counter
        (the static one, not yet overwritten)."""
        if not values:
            return
        i = self._static.step - self._start
        for name, value in values.items():
            k = self._every.get(name, 1)
            row = i if k == 1 else torch.div(i - self._offsets[k], k, rounding_mode="floor")
            row = row.reshape(1).long()
            for buf, v in zip(_tensors(self._bufs[name]), _tensors(value)):
                buf.index_copy_(0, row, v.reshape((1,) + tuple(v.shape)).to(buf.dtype))

    def _commit(self, new):
        """Copy the new state's leaves into the static buffers (a leaf that
        shares memory with a buffer is copied aside first)."""
        if _skeleton(new) != self._layout:
            raise ValueError("run_jit: the step changed the state's tree, shapes, "
                             "dtypes or static fields; the compiled run needs them fixed")
        leaves = [x for _, x in _leaves_with_paths(new)]
        srcs = [None if s is d else
                s.clone() if s.untyped_storage().data_ptr() in self._ptrs else s
                for s, d in zip(leaves, self._leaves)]
        for s, d in zip(srcs, self._leaves):
            if s is not None:
                d.copy_(s)

    def _step(self, host: int, branches: Branches):
        new = self.scheduler.step_at(self._static, host, branches=branches)
        self._record(self._values(new, host))
        self._commit(new)

    def _eager(self, host: int, first: bool = False) -> tuple:
        """One eager step (recording its branches); captures the graph of
        its key if there is none yet.  Returns the branches taken."""
        branches = Branches()
        new = self.scheduler.step_at(self._static, host, branches=branches)
        values = self._values(new, host, protos=first)
        if first:
            self._ensure_buffers(values, self._rows)
            values = {n: v for n, v in values.items()
                      if self._every.get(n, 1) == 1 or host % self._every[n] == 0}
        self._record(values)
        self._commit(new)
        self.stats["eager_steps"] += 1
        key = (self._pattern(host), branches.key())
        if key not in self._graphs:
            self._capture(key, host)
        return branches.key()

    # -- graphs ---------------------------------------------------------------

    def _capture(self, key: tuple, host: int):
        assumed = dict(key[1])
        body = lambda: self._step(host, Branches(assumed, self._diverged))
        self.stats["graphs"] += 1
        if self._stream is None:
            self._graphs[key] = body
            return
        from repro_torch import kernels

        t0 = time.perf_counter()
        before = kernels.read_launches()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool)
        try:
            body()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
        after = kernels.read_launches()
        kernels.add_launches({n: before[n] - after[n] for n in after})
        self._graphs[key] = (graph, {n: after[n] - before[n] for n in after})
        self.stats["capture_s"] += time.perf_counter() - t0

    def _replay(self, entry):
        if self._stream is None:
            entry()
        else:
            from repro_torch import kernels

            graph, launches = entry
            graph.replay()
            kernels.add_launches(launches)
        self.stats["replays"] += 1

    # -- the run --------------------------------------------------------------

    def __call__(self, state, n_steps: int, collect: Optional[Callable] = None,
                 observables: Optional[Tuple[Tuple[str, Callable, int], ...]] = None):
        global _running
        if collect is not None and observables:
            raise ValueError("pass either collect= or observables=, not both")
        obs = tuple(observables or ())
        names = [n for n, _, _ in obs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate observable names in {names}")
        n = int(n_steps)
        self._collect = collect
        self._streamed = tuple((name, f) for name, f, k in obs if k == 1)
        self._gated = tuple((name, f, k) for name, f, k in obs if k > 1)
        self._every = {name: k for name, _, k in self._gated}
        self._rows = {name: n for name, _ in self._streamed}
        self._rows.update({name: -(-n // k) for name, _, k in self._gated})
        if collect is not None:
            self._rows["collect"] = n
        _running += 1
        try:
            if n <= 0:
                return self._empty(state, n)
            start = int(state.step)
            self._prepare(state, (collect, self._streamed, self._gated))
            with self._on_stream():
                self._start.fill_(start)
                for _, _, k in self._gated:
                    if k not in self._offsets:
                        self._offsets[k] = torch.zeros((), dtype=torch.int32,
                                                       device=self._device)
                    self._offsets[k].fill_((-start) % k)
                self._drive(start, n)
            final = _map_with_paths(self._static, lambda p, x: x.clone())
            return final, self._outs(n, state)
        finally:
            _running -= 1

    def _drive(self, start: int, n: int):
        host, end = start, start + n
        branches = self._eager(host, first=True)
        host += 1
        while host < end:
            first = host
            missing = False
            while host < end and host - first < CHUNK:
                entry = self._graphs.get((self._pattern(host), branches))
                if entry is None:
                    missing = True
                    break
                if host == first:
                    for s, d in zip(self._leaves, self._saved):
                        d.copy_(s)
                    self._diverged.zero_()
                self._replay(entry)
                host += 1
            if host > first and bool(self._diverged):
                for s, d in zip(self._saved, self._leaves):
                    d.copy_(s)
                self.stats["rollbacks"] += 1
                self.stats["rolled_back_steps"] += host - first
                for h in range(first, host):
                    branches = self._eager(h)
                continue
            if missing:
                branches = self._eager(host)
                host += 1

    def _outs(self, n: int, state):
        if self._collect is not None:
            buf = self._bufs["collect"]
            return _rebuild(buf, [t[:n].clone() for t in _tensors(buf)])
        if not self._rows:
            return torch.zeros((n,), dtype=torch.int32, device=state.pool.device)
        return {name: self._bufs[name][:rows].clone() for name, rows in self._rows.items()}

    def _empty(self, state, n: int):
        """A run of no steps: what ``engine.run`` returns."""
        if self._collect is not None:
            return state, {}
        if not self._rows:
            return state, torch.zeros((0,), dtype=torch.int32, device=state.pool.device)
        fns = dict(self._streamed)
        fns.update({name: f for name, f, _ in self._gated})
        outs = {}
        for name in self._rows:
            proto = fns[name](state)
            outs[name] = torch.zeros((0,) + tuple(proto.shape), dtype=proto.dtype,
                                     device=proto.device)
        return state, outs
