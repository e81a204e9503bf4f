"""The port's spans and counters (``repro_torch.core.spans``) on the CPU.

Spans open only while ``torch.profiler`` records, nested as the program
runs (on the CPU a runner's "graph" is its step's body called again, so the
op spans show inside each replay); the runner's reads and replays are
counted and timed; the op map that a capture records holds the step's ops
and observables in order; under the profiler the log holds each replay's op
map and each chunk's closing marker, for one profiled stretch; an op opens
its span exactly where its gate lets it run.  The card's half (graph nodes,
markers, a profiled run's events between its markers) is in
``tests/test_torch_cuda.py``; the attribution of a trace's device events to
the segments is the benchmark's (``abm_bench/harness/program_spans.py``).
This module imports no JAX.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import torch_jit_cases as J
from repro_torch.core import runner as runner_mod
from repro_torch.core import spans
from repro_torch.core.forces import Branches
from repro_torch.core.schedule import Operation, Scheduler, run_op, runs_at

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.LOG.clear()
    yield
    spans.LOG.clear()
    torch.set_num_threads(before)


@pytest.fixture
def sleeps(monkeypatch):
    """The marker kernels enqueued (``torch.cuda._sleep``), by their cycles."""
    seen = []
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: seen.append(cycles))
    return seen


@pytest.fixture
def opened(monkeypatch):
    """The arguments of every span that opened a profiler range."""
    seen = []
    real = spans._record

    def record(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(spans, "_record", record)
    return seen


def _soma(**kw):
    return J.soma(CPU, n=60, space=60.0, res=6, **kw).build()


def _parents(ev):
    out = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        out.append(ev.name)
    return out


def test_spans_nest_under_the_profiler():
    built = _soma()
    built.run_jit(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        built.run_jit(3)
    events = prof.events()
    names = {e.name for e in events}
    assert {"facade.run_jit", "runner.read", "runner.replay", "op.fold_rng", "op.forces",
            "op.exposure", "observe.position"} <= names
    replays = [e for e in events if e.name == "runner.replay"]
    assert len(replays) == 3 and all(_parents(e)[-1] == "facade.run_jit" for e in replays)
    forces = [e for e in events if e.name == "op.forces"]
    assert len(forces) == 3
    assert all(_parents(e)[:2] == ["runner.replay", "facade.run_jit"] for e in forces)
    ours = [e for e in events if e.name.startswith(("facade.", "runner."))]
    assert len(ours) == 1 + 3 + 3
    assert all(not e.is_user_annotation for e in events if e.name.startswith(("op.", "runner.")))
    assert spans.LOG == []


def test_no_span_marker_or_log_without_the_profiler(opened, sleeps):
    built = _soma()
    built.run_jit(3)
    built.run_jit(3)
    eng = built.batched()
    eng.run_jit(eng.sweep_state(batch=2), 2)
    assert opened == [] and sleeps == [] and spans.LOG == []


@pytest.mark.parametrize("n", [1, 10])
def test_reads_are_the_facade_the_count_and_one_a_chunk(monkeypatch, n):
    monkeypatch.setattr(runner_mod, "CHUNK", 4)
    built = _soma()
    built.run_jit(n)
    runner = built._jitted
    before = dict(runner.stats)
    built.run_jit(n)
    d = {k: runner.stats[k] - before[k] for k in ("reads", "replays", "read_s", "replay_s")}
    assert d["replays"] == n and runner.stats["warm_starts"] == 1
    assert d["reads"] == 1 + 1 + -(-n // 4)
    assert d["read_s"] > 0 and d["replay_s"] > 0


def test_a_batched_runner_counts_and_times_its_stacks():
    built = _soma()
    eng = built.batched()
    stats = eng._jitted.stats
    before = dict(stats)
    bstate = eng.stack([built.state, built.state])
    assert bstate.active.tolist() == [True, True]
    assert stats["stacks"] - before["stacks"] == 1 and stats["stack_s"] > before["stack_s"]
    assert "stacks" not in built._jitted.stats


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched: the stand-in, on the CPU, for the
    nodes a capture adds to its graph."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _mapped_step(runner, batched=False):
    """The op map of one step of the runner's last layout from its static
    state, as its capture runs it (the assumed branches of a graph it
    holds; the observables' rows from row 0)."""
    lay = next(reversed(runner._layouts.values()))
    counter = lay.static.states.step if batched else lay.static.step
    lay.start.copy_(counter)
    host = tuple(counter.tolist()) if batched else int(counter)
    assumed = dict(next(iter(lay.graphs))[1])
    with _Ops() as ops:
        with spans.mapping(lambda: ops.n) as op_map:
            runner._step(lay, host, runner._live(host), Branches(assumed, lay.diverged))
    assert sum(n for _, n in op_map.entries) == ops.n
    return host, op_map.entries


def _segments(entries):
    return [name for name, _ in entries if name != "record"]


def test_the_op_map_of_a_solo_step_holds_its_ops_and_observables_in_order():
    built = _soma(sort_frequency=4)
    built.run_jit(16)
    ops = [f"op.{op.name}" for op in built.scheduler.ordered_ops()]
    observed = ["observe.position", "observe.exposure"]
    host, on = _mapped_step(built._jitted)
    assert host == 16
    assert _segments(on) == ["op.fold_rng"] + ops + observed
    assert on[-1][0] == "record" and dict(on)["op.forces"] > 0
    host, off = _mapped_step(built._jitted)
    assert host == 17
    assert _segments(off) == ["op.fold_rng"] + [o for o in ops if o != "op.sort"] + observed


def test_the_op_map_of_a_batched_step_holds_its_ops_and_observables_in_order():
    built = _soma(sort_frequency=4)
    eng = built.batched()
    eng.run_jit(eng.sweep_state(batch=2), 8)
    ops = [f"op.{op.name}" for op in built.scheduler.ordered_ops()]
    observed = ["observe.position", "observe.exposure", "observe.kind_counts"]
    host, on = _mapped_step(eng._jitted, batched=True)
    assert host == (8, 8)
    assert _segments(on) == ["op.fold_rng"] + ops + observed[:2]
    host, off = _mapped_step(eng._jitted, batched=True)
    assert host == (9, 9)
    assert _segments(off) == ["op.fold_rng"] + [o for o in ops if o != "op.sort"] + observed


# ---------------------------------------------------------------- the log

class _Graph:
    """On the CPU, in a captured graph's place: its step's body, replayed."""

    def __init__(self, body):
        self.replay = body


MAP = (("op.all", 1),)


def _as_graphs(runner):
    """The runner's CPU "graphs" (bodies) as replayable graphs with an op map,
    its layouts given a pool, as on the card."""
    for lay in runner._layouts.values():
        for key, body in lay.graphs.items():
            lay.graphs[key] = (_Graph(body), {})
            lay.op_maps[key] = MAP
        lay.pool = "pool"


def test_the_log_holds_each_replay_and_closes_each_chunk(sleeps, monkeypatch):
    monkeypatch.setattr(runner_mod, "CHUNK", 4)
    built = _soma()
    built.run_jit(10)
    _as_graphs(built._jitted)
    with profile(activities=[ProfilerActivity.CPU]):
        built.run_jit(10)
    chunk = [MAP] * 4 + [spans.CLOSE]
    assert spans.LOG == chunk + chunk + [MAP, MAP, spans.CLOSE]
    assert sleeps == [0] * len(spans.LOG)
    built.run_jit(10)
    assert len(spans.LOG) == 13 and len(sleeps) == 13
    with profile(activities=[ProfilerActivity.CPU]):
        built.run_jit(3)
    assert spans.LOG == [MAP, MAP, MAP, spans.CLOSE] and len(sleeps) == 17


@pytest.mark.parametrize("entries, stale, want", [
    ([MAP, spans.CLOSE], False, [None, MAP, spans.CLOSE]),
    ([MAP, spans.CLOSE], True, [MAP, spans.CLOSE]),
    ([spans.EAGER, MAP], True, [spans.EAGER, MAP]),
])
def test_a_run_without_the_profiler_starts_the_log_anew(sleeps, entries, stale, want):
    spans.mark_replay(None)
    if stale:
        spans.unprofiled_run()
    for e in entries:
        {MAP: lambda: spans.mark_replay(MAP), spans.CLOSE: spans.close_replays,
         spans.EAGER: spans.log_eager}[e]()
    assert spans.LOG == want
    assert len(sleeps) == 1 + sum(e != spans.EAGER for e in entries)


# ------------------------------------------------------------------ gates

@dataclasses.dataclass
class _Count:
    step: int


@pytest.mark.parametrize("frequency, gate, step, runs", [
    (0, "cond", 0, False), (1, "cond", 5, True), (4, "cond", 8, True), (4, "cond", 9, False),
    (4, "mask", 8, True), (4, "mask", 9, True),
])
def test_an_op_runs_and_opens_its_span_where_its_gate_lets_it(frequency, gate, step, runs):
    calls = []
    op = Operation(name="x", fn=lambda ctx, s: calls.append(s) or "new",
                   frequency=frequency, gate=gate)
    assert runs_at(op, step) == runs
    out = run_op(op, None, "old", step)
    assert calls == (["old"] if runs else [])
    assert out == ("new" if frequency and step % frequency == 0 else "old")
    op = dataclasses.replace(op, fn=lambda ctx, s: s)
    sched = Scheduler(config=None, ops=(op,), fold_rng=lambda s, c: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert sched.step_at(_Count(step), step) == _Count(step + 1)
    assert ("op.x" in {e.name for e in prof.events()}) == runs


def test_a_capture_error_names_the_span():
    err = spans.CaptureError("x")
    assert isinstance(err, ValueError)
    assert spans._what("op.reads") == "op 'reads'"
    assert spans._what("op.fold_rng") == "fold_rng"
    assert spans._what("observe.counts") == "observable 'counts'"
