"""The per-layer metrics that read the program's own spans, counters and op
maps: discovery finds them, each returns None where the program or the run
gives it nothing, and each gives its value on a synthetic trace; the
attribution of a trace's device events to the replays' segments sums them
exactly and refuses what it cannot attribute."""

import json
import sys
import types

import pytest

from abm_bench.harness import program_spans, spec
from abm_bench.harness.trace import Trace
from repro_torch.core import spans

CELLS = ("soma-tissue.long", "tumor-spheroid.jobs", "soma-tissue.sweep")
NEW = {
    "replay_launch_ms": CELLS, "host_read_ms": CELLS, "idle_in_launch_pct": CELLS,
    "idle_in_read_pct": CELLS, "reads_per_unit": CELLS,
    "idle_outside_run_pct": CELLS, "stack_ms": ("soma-tissue.sweep",),
    "grid_op_ms": CELLS, "behaviors_op_ms": CELLS, "mechanics_op_ms": CELLS,
    "diffusion_op_ms": ("soma-tissue.long", "soma-tissue.sweep"), "health_op_ms": CELLS,
    "other_op_ms": CELLS, "record_ms": CELLS, "outside_graph_ms": CELLS,
}


@pytest.fixture(autouse=True)
def empty_log():
    spans.LOG.clear()
    yield
    spans.LOG.clear()


def _reader(name):
    return spec.Cell.metric_reader(types.SimpleNamespace(bench_dir=spec.BENCH_DIR), name)


def test_discovery_finds_the_new_metrics_in_their_cells():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell in CELLS:
        found = {m["name"] for m in spec.find_cell(cell).per_layer}
        assert {n for n, cells in NEW.items() if cell in cells} <= found
        assert not {n for n, cells in NEW.items() if cell not in cells} & found
    for name in NEW:
        assert callable(_reader(name).read)
        assert entries[name]["moves"] == ("job_p95_ms" if name == "stack_ms"
                                          else "agent_steps_per_s")


M, CLOSE = spans.MARKER, spans.CLOSE
# One replayed step's op map: a node a segment, each 2 µs on the device.
OP_MAP = tuple((name, 1) for name in (
    "op.fold_rng", "op.sort", "op.behaviors", "op.forces", "op.diffusion", "op.health",
    "op.age", "observe.kind_counts", "record"))


def _graph(t0):
    return [(M, t0, t0 + 1)] + [(f"k{i}", t0 + 2 + 2 * i, t0 + 4 + 2 * i) for i in range(9)]


def _trace():
    """200 µs traced: a stack, a run with two replays (launched 20-30 and
    60-70 µs, both idle) closed by a marker, the chunk's read (100-110 µs,
    idle), the caller's read after the run; outside the run the stretch's
    events cover 0-10 and 150-190 µs, 5 of them busy."""
    device = ([("copy", 12.0, 18.0)] + _graph(30.0) + _graph(70.0)
              + [(M, 92.0, 93.0), ("reduce", 95.0, 100.0), ("read", 185.0, 190.0)])
    host = [("batch.stack", 0.0, 10.0), ("facade.run_jit", 10.0, 150.0),
            ("runner.replay", 20.0, 30.0), ("runner.replay", 60.0, 70.0),
            ("runner.read", 100.0, 110.0), ("aten::sum", 160.0, 190.0)]
    return Trace(device=device, host=host, window_s=200e-6, steps=2, launches={}, states=[])


def _ctx(trace=None, window_stats=None, units=3):
    return types.SimpleNamespace(trace=trace, window_stats=window_stats or {},
                                 units=[object()] * units, steps=80, cfg={}, traffic={})


WANT = {
    "replay_launch_ms": 0.5, "host_read_ms": 1.0, "reads_per_unit": 3.0,
    "idle_in_launch_pct": 100.0 * 20 / 200, "idle_in_read_pct": 100.0 * 10 / 200,
    "idle_outside_run_pct": 100.0 * 45 / 200, "stack_ms": 3.0,
    "grid_op_ms": 0.002, "behaviors_op_ms": 0.002, "mechanics_op_ms": 0.002,
    "diffusion_op_ms": 0.002, "health_op_ms": 0.002, "other_op_ms": 0.004,
    "record_ms": 0.004, "outside_graph_ms": 0.008,
}


def test_each_reader_gives_its_value_on_a_synthetic_trace():
    spans.LOG.extend([OP_MAP, OP_MAP, CLOSE])
    ctx = _ctx(_trace(), {"replay_s": 0.004, "replays": 8, "read_s": 0.003, "reads": 9,
                          "stack_s": 0.006, "stacks": 2})
    got = {name: _reader(name).read(ctx) for name in NEW}
    assert got == pytest.approx(WANT, rel=1e-9)
    assert spans.LOG == [OP_MAP, OP_MAP, CLOSE]
    # The step's device time is shared out whole: the markers' own apart.
    device_ms = 1e3 * sum(e - s for n, s, e in ctx.trace.device if n != M) / 1e6 / 2
    parts = [v for k, v in got.items() if k.endswith("_op_ms") or k in ("record_ms",
                                                                        "outside_graph_ms")]
    assert sum(parts) == pytest.approx(device_ms, rel=1e-12)
    idle = [got[k] for k in ("idle_in_launch_pct", "idle_in_read_pct", "idle_outside_run_pct")]
    assert sum(idle) <= 100.0 * (1 - ctx.trace.busy_s / ctx.trace.window_s)


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_gives_nothing_without_a_trace_or_counters(name):
    assert _reader(name).read(_ctx()) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_gives_nothing_from_a_program_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    tr = _trace()
    tr.host = [h for h in tr.host if "." not in h[0]]
    tr.device = [d for d in tr.device if d[0] != M]
    stats = {"replays": 8, "eager_steps": 0, "capture_s": 1.0}
    assert _reader(name).read(_ctx(tr, stats)) is None


def test_an_eager_step_in_the_log_silences_the_op_readers():
    spans.LOG.extend([OP_MAP, spans.EAGER, OP_MAP, CLOSE])
    ctx = _ctx(_trace())
    assert all(_reader(n).read(ctx) is None for n in NEW if n.endswith("_op_ms"))
    assert program_spans.op_seconds(ctx.trace) is None


# ------------------------------------------------------------- attribution

def _ev(name, start, dur):
    return (name, float(start), float(start + dur))


# Two replays of a graph of 3 nodes (a: 1, b: 2) in a chunk, closed, then one
# of a graph of 2 (a: 2), closed; events in µs, in time order.
MAP3, MAP2 = (("op.a", 1), ("op.b", 2)), (("op.a", 2),)
LOG = [MAP3, MAP3, CLOSE, MAP2, CLOSE]
EVENTS = [
    _ev("copy", 0, 5),
    _ev(M, 10, 1), _ev("k1", 12, 10), _ev("k2", 23, 20), _ev("k3", 44, 30),
    _ev(M, 90, 1), _ev("k1", 92, 11), _ev("k2", 104, 21), _ev("k3", 126, 31),
    _ev(M, 158, 1), _ev("reduce", 160, 4),
    _ev(M, 170, 1), _ev("k4", 172, 7), _ev("k5", 180, 8),
    _ev(M, 190, 1), _ev("read", 192, 2),
]


def _attribute(events, log):
    return program_spans.op_device_seconds(events, log, M, CLOSE, spans.EAGER)


def test_op_device_seconds_sums_each_segment_and_the_rest():
    log = list(LOG)
    got = _attribute(list(reversed(EVENTS)), log)
    assert log == LOG
    assert got == pytest.approx({"op.a": (10 + 11 + 7 + 8) / 1e6,
                                 "op.b": (20 + 30 + 21 + 31) / 1e6,
                                 "outside_graph": (5 + 4 + 2) / 1e6}, abs=1e-15)
    total = sum(e - s for n, s, e in EVENTS if n != M) / 1e6
    assert sum(got.values()) == pytest.approx(total, rel=1e-12)


@pytest.mark.parametrize("case", ["short_replay", "long_replay", "lost_last_of_chunk",
                                  "lost_last_of_run", "eager_step", "no_op_map", "unclosed", "empty_log",
                                  "more_markers", "more_log"])
def test_op_device_seconds_refuses_what_it_cannot_attribute(case):
    events, log = list(EVENTS), list(LOG)
    if case == "short_replay":
        log[1] = (("op.a", 4),)
    elif case == "long_replay":
        log[1] = (("op.a", 2),)
    elif case == "lost_last_of_chunk":
        # The profiler lost the chunk's last node event: the divergence
        # reduce after the closing marker may not stand in for it.
        events.remove(_ev("k3", 126, 31))
    elif case == "lost_last_of_run":
        events.remove(_ev("k5", 180, 8))
    elif case == "eager_step":
        log = [MAP3, spans.EAGER] + log[1:]
    elif case == "no_op_map":
        log[1] = None
    elif case == "unclosed":
        events, log = events[:-2], log[:-1]
    elif case == "empty_log":
        events, log = [e for e in events if e[0] != M], []
    elif case == "more_markers":
        events.append(_ev(M, 200, 1))
    else:
        log.append(MAP2)
    assert _attribute(events, log) is None
