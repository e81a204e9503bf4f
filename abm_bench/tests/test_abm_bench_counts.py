"""The yardstick's arithmetic against hand counts at small shapes, the
end-to-end and idle arithmetic on synthetic spans, and the traced steps
each counted at its own input."""

import types

import pytest
import torch

from abm_bench.harness import cli, counts, drive, peaks, trace


def test_box_pairs_counts_ordered_pairs_of_adjacent_boxes():
    n = 4
    c = torch.zeros(n ** 3, dtype=torch.long)
    c[0] = 2                                   # two agents in box (0, 0, 0): 2 pairs
    assert counts.box_pairs(c, n) == 2
    c[(1 * n + 1) * n + 1] = 1                 # one in (1, 1, 1), adjacent: 2·1 + 1·2 more
    assert counts.box_pairs(c, n) == 2 + 4
    c[(3 * n + 3) * n + 3] = 5                 # five far away: 5·4 among themselves
    assert counts.box_pairs(c, n) == 6 + 20


def test_cell_list_force_bytes_and_ops_by_hand():
    n, m, cap = 2, 16, 10
    c = torch.tensor([0, 1, 9, 0, 0, 0, 0, 0])
    # rows: (1, 2, 10, 1, ...) slots of 4 bytes in 32-byte sectors: 32, 32, 64, 32 x 5
    want_bytes = 32 + 32 + 64 + 5 * 32 + 16 * 10 + 12 * cap
    b, ops = counts.cell_list_force(c, n, m, cap)
    assert b == want_bytes
    # every box of a 2^3 grid is adjacent to every other: 10 agents, 90 pairs
    assert ops == counts.PAIR_OPS * 90


def test_rank_window_diffusion_and_state_bytes_by_hand():
    c = torch.tensor([3, 0, 1])
    assert counts.cell_rank(c, 7) == (56, 9 + 1 + 28)
    assert counts.cell_window_force(torch.zeros(8, dtype=torch.long), 2, 100) == (3200, 0)
    assert counts.diffusion(1000) == (8000, 8000)
    snap = {"position": torch.zeros(5, 3), "diameter": torch.zeros(5), "kind": torch.zeros(5, dtype=torch.int32),
            "age": torch.zeros(5), "alive": torch.zeros(5, dtype=torch.bool),
            "static": torch.zeros(5, dtype=torch.bool), "attrs": {"x": torch.zeros(5)},
            "fields": {"f": torch.zeros(2, 2, 2)}}
    assert counts.state_bytes(snap) == 2 * (5 * (12 + 4 + 4 + 4 + 1 + 1 + 4) + 8 * 4)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def _units(times, agents=1000):
    out, t = [], 0.0
    for d in times:
        out.append(drive.Unit(start=t, end=t + d, steps=10, agent_steps=agents, host_s=0.0,
                              failed=False))
        t += d
    return out


def _e2e(units):
    cell = types.SimpleNamespace(end_to_end=[
        {"name": "agent_steps_per_s", "unit": "agent-steps/s"},
        {"name": "job_p95_ms", "unit": "ms"}])
    drv = types.SimpleNamespace(units=units)
    got = cli.e2e_metrics(cell, drv, 0.0, units[-1].end, 1.0, 0)
    return got["agent_steps_per_s"]["value"], got["job_p95_ms"]["value"]


def test_a_stall_in_the_window_moves_the_rate_and_the_tail():
    rate, p95 = _e2e(_units([0.3] * 100))
    assert rate == pytest.approx(100 * 1000 / 30.0)
    assert p95 == pytest.approx(300.0)
    # Six jobs stalled by a second each: the rate falls, the tail rises.
    stalled = [0.3] * 94 + [1.3] * 6
    rate2, p952 = _e2e(_units(stalled))
    assert rate2 < rate * 0.85
    assert p952 > 1000.0


def test_idle_share_counts_a_stall_between_device_work():
    def tr(intervals, wall):
        dev = [("k", s, e) for s, e in intervals]
        return trace.Trace(device=dev, host=[("cudaGraphLaunch", 0.0, 1e9)], window_s=wall,
                           steps=10, launches={}, states=[])

    from abm_bench.harness.spec import load_module, BENCH_DIR

    idle = load_module(BENCH_DIR / "metrics" / "device_idle_pct.py", "idle_test")
    busy = tr([(0, 400_000), (300_000, 900_000)], 1.0)       # overlapping: 0.9 s busy
    assert busy.busy_s == pytest.approx(0.9)
    assert idle.read(types.SimpleNamespace(trace=busy)) == pytest.approx(10.0)
    stall = tr([(0, 400_000), (300_000, 900_000), (1_400_000, 1_500_000)], 1.5)
    assert idle.read(types.SimpleNamespace(trace=stall)) == pytest.approx(100 * (1 - 1.0 / 1.5))
    assert [round(s, 6) for _, s in stall.idle_gaps()] == [0.5]
    assert stall.breakdown()["idle_gaps"][0][0] == "cudaGraphLaunch"


def _view(cnt, capacity, n):
    snap = {k: torch.zeros(capacity) for k in ("diameter", "age")}
    snap.update(position=torch.zeros(capacity, 3), kind=torch.zeros(capacity, dtype=torch.int32),
                alive=torch.zeros(capacity, dtype=torch.bool),
                static=torch.zeros(capacity, dtype=torch.bool), attrs={},
                fields={"f": torch.zeros(4, 4, 4)}, step=0)
    view = counts.work_view(snap, {"space": 20.0, "box_um": 10.0})
    view["box_counts"] = torch.tensor(cnt, dtype=torch.int32)
    return view


def test_work_view_keeps_box_counts_and_shapes():
    snap = {"position": torch.tensor([[1.0, 1.0, 1.0], [15.0, 1.0, 1.0], [16.0, 2.0, 3.0]]),
            "alive": torch.tensor([True, True, False]), "attrs": {"a": torch.zeros(3)},
            "fields": {"f": torch.zeros(4, 4, 4)}, "step": 7}
    view = counts.work_view(snap, {"space": 20.0, "box_um": 10.0})
    assert view["box_counts"].tolist() == [1, 0, 0, 0, 1, 0, 0, 0]
    assert view["position"].is_meta and view["position"].shape == (3, 3)
    assert view["fields"]["f"].numel() == 64 and view["step"] == 7
    assert counts.cell_counts(view, {}) is view["box_counts"]


def test_rooflines_count_each_traced_step_at_its_own_input():
    """Two traced steps, the second with twice the agents: each call is
    counted at its own step's input, the calls spread evenly over them."""
    cfg = {"space": 20.0, "box_um": 10.0, "max_per_cell": 16}
    n, cap = 2, 64
    one = [3, 0, 0, 0, 0, 0, 0, 0]
    two = [3, 0, 0, 0, 0, 0, 0, 3]
    tr = trace.Trace(device=[("window_force_kernel", 0.0, 10.0)], host=[], window_s=1e-3,
                     steps=2, launches={"cell_window_force": 4},
                     states=[[_view(one, cap, n)], [_view(two, cap, n)]])
    work = lambda snap, cnt, n: counts.cell_window_force(cnt, n, cap)
    got = counts.roofline_pct(tr, cfg, "cell_window_force", ("window_force_kernel",), work)
    least = [peaks.least_seconds(32 * cap, counts.PAIR_OPS * p) for p in (6, 30)]
    assert got == pytest.approx(100.0 * 2 * sum(least) / 10e-6)
    from abm_bench.harness.spec import BENCH_DIR, load_module

    mfu = load_module(BENCH_DIR / "metrics" / "step_mfu.py", "mfu_test")
    step_bytes = counts.state_bytes(tr.states[0][0])
    want = sum(peaks.least_seconds(step_bytes, counts.PAIR_OPS * p) for p in (6, 30))
    got = mfu.read(types.SimpleNamespace(trace=tr, cfg=cfg))
    assert got == pytest.approx(100.0 * want / 1e-3)


def test_a_traced_run_counts_every_traced_step_at_its_input(tiny_root, cpu_threads,
                                                            monkeypatch):
    """The growing spheroid: one work view a traced step, whose live agents
    are those of that step's input (two 9-step jobs traced, to keep the
    CPU's profiler short)."""
    from abm_bench.harness import spec

    monkeypatch.setattr(drive, "SPAN_STEPS", 18)

    cell = spec.find_cell("tumor-spheroid.jobs", root=tiny_root)
    drv = drive.loop_for(cell, 31, "cpu")
    drv.setup()
    drv.window(0.2, trace=True)
    live = []
    for case in drv.trace_cases:
        drv.replay(case, lambda i, s, out, obs: live.append(int(s.pool.alive.sum())))
    drv.count_traced()
    states = drv.trace.states
    assert len(states) == drv.trace.steps == len(live) >= drive.SPAN_STEPS
    assert [int(s[0]["box_counts"].sum()) for s in states] == live
    assert live[-1] > live[0]
