"""One run of one cell: set-up, the measured window, the check, the result line.

``python abm_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from the
counters and spans of the whole window and from a device trace of a few of
its units.  The last line of standard output is the result, one JSON
object; the last lines of standard error give each number the check
compared beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time
import types

import torch

from . import check as _check
from . import drive as _drive
from . import spec as _spec
from . import trace as _trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# Steps of each replayed unit at which the reference follows the program.
CHECK_STEPS = 3


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def build_kernels(names) -> float:
    """Build the program's CUDA kernels that the configuration runs (a
    build already in the checkout is reused); the wall seconds of the
    compile, 0 when nothing was compiled."""
    from repro_torch.kernels import _build

    t = time.perf_counter()
    built = _build.build(names)
    wall = time.perf_counter() - t
    return wall if any(b.seconds > 0 for b in built.values()) else 0.0


def check_steps(cell, drv, case, rnd: random.Random) -> list:
    """Offsets into a sampled unit at which the reference follows the
    program: the first step at which each gated op of the configuration
    fires, then steps drawn from the seed, ``CHECK_STEPS`` in all."""
    start = drv.counter_at(case)
    want = CHECK_STEPS
    at = []
    for f in cell.cfg.get("check_frequencies", []):
        first = next((i for i in range(case.steps) if (start + i) % int(f) == 0), None)
        if first is not None and first not in at:
            at.append(first)
    rest = [i for i in range(case.steps) if i not in at]
    rnd.shuffle(rest)
    return sorted(at + rest[: max(0, want - len(at))])


def program_pairs(cell, drv, seed: int) -> tuple:
    """Replay each sampled unit a step a call: the snapshots the reference
    reads, and the leaves in which the replays' ends differ from the
    window's answers."""
    rnd = random.Random(seed + 1)
    pairs, chain_off = [], 0
    for case in drv.cases:
        at = set(check_steps(cell, drv, case, rnd))

        def visit(i, before, after, obs):
            if i in at:
                for (x, _), (y, o) in zip(drv.sessions(before), drv.sessions(after, obs)):
                    pairs.append((_check.snapshot(x), _check.snapshot(y), o))

        chain_off += drv.replay(case, visit)
    return pairs, chain_off, len(drv.cases)


def reference_numbers(cell, pairs, dtype=torch.float32, control=False) -> dict:
    """The numbers of every checked step; with ``control`` the reference at
    ``dtype`` stands in the program's place (its state after each step is
    compared with the f32 reference's)."""
    ref, cfg = cell.reference, cell.cfg
    readings = []
    for before, after, obs in pairs:
        want = ref.step(cfg, before, torch.float32)
        want_obs = ref.observed(cfg, want)
        if control:
            after = ref.step(cfg, before, dtype)
            obs = ref.observed(cfg, after)
        readings.append(_check.compare(after, want, obs, want_obs))
        del want
    return _check.merge(readings)


def e2e_metrics(cell, drv, t0, t1, setup_s, peak) -> dict:
    units = drv.units
    values = {
        "agent_steps_per_s": sum(u.agent_steps for u in units) / (t1 - t0),
        "setup_s": setup_s,
        "peak_mem_gib": peak / 2 ** 30,
    }
    if len(units) >= 2:
        values["job_p95_ms"] = 1e3 * statistics.quantiles(
            [u.end - u.start for u in units], n=100, method="inclusive")[94]
    out = {}
    for m in cell.end_to_end:
        if m["name"] in values:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def window_stats(drv) -> dict:
    """The runner's counters over the window."""
    return {k: v - drv.runner_stats.get(k, 0) for k, v in drv.runner.stats.items()
            if isinstance(v, (int, float))}


def layer_metrics(cell, drv, stats) -> dict:
    ctx = types.SimpleNamespace(
        cfg=cell.cfg, traffic=cell.traffic, build_s=drv.build_s,
        capture_s=drv.runner_stats.get("capture_s", 0.0), window_stats=stats,
        units=drv.units, steps=sum(u.steps for u in drv.units), trace=drv.trace)
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             root=_spec.ROOT, bench=None, control=None) -> dict:
    """One run; returns the result object (the caller prints it).
    ``control`` (``calibrate.py``, never the benchmark's own runs): a lower
    precision in which the reference also stands in the program's place on
    the same checked steps; its numbers go under ``"control"``."""
    entered_s = process_age_s()
    cell = _spec.find_cell(workload, root=root, bench=bench)
    limits = _check.load_limits(cell.bench_dir, workload)
    card = torch.device(device).type == "cuda"
    compile_s = build_kernels(cell.model.KERNELS) if card else 0.0
    if card:
        torch.cuda.reset_peak_memory_stats()
    drv = _drive.loop_for(cell, seed, device)
    drv.setup()
    _drive.sync(device)
    setup_s = process_age_s() - compile_s
    t0, t1 = drv.window(seconds, trace)
    _drive.sync(device)
    peak = torch.cuda.max_memory_allocated() if card else 0
    stats = window_stats(drv)
    if drv.trace is not None:
        _trace.parse(drv.trace)
        drv.count_traced()
    if trace:
        metrics = layer_metrics(cell, drv, stats)
    else:
        metrics = e2e_metrics(cell, drv, t0, t1, setup_s, peak)

    build_s, warm_s = drv.build_s, drv.warm_s
    capture_s = drv.runner_stats.get("capture_s", 0.0)
    pairs, chain_off, cases = program_pairs(cell, drv, seed)
    start_off = drv.start_off
    units, failed = len(drv.units), sum(u.failed for u in drv.units)
    busy = (drv.trace.busy_s, drv.trace.window_s) if drv.trace is not None else None
    breakdown = drv.trace.breakdown() if drv.trace is not None else None
    drv.free()
    del drv
    if card:
        torch.cuda.empty_cache()
    numbers = reference_numbers(cell, pairs)
    numbers.update(chain_off=chain_off, start_off=start_off)
    control_numbers = (reference_numbers(cell, pairs, control, control=True)
                       if control is not None else None)
    correct, shown = _check.judge(numbers, limits)
    # Every unit of the window with clean telemetry (no agent dropped, no
    # crowded box, nothing non-finite), as the configurations guarantee: the
    # reference, following the program's steps, would drop the same agents.
    shown["unclean_units"] = {"value": failed, "limit": 0}
    correct = correct and cases > 0 and failed == 0

    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(0) if card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if busy is not None:
        dev["busy_s"], dev["window_s"] = busy
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compile_s"] = compile_s
    result["setup_split"] = {"process_to_harness_s": entered_s, "build_s": build_s,
                             "warm_s": warm_s, "capture_s": capture_s}
    result["checked"] = {"units": cases, "steps": len(pairs), "numbers": numbers}
    if control_numbers is not None:
        result["control"] = control_numbers
    result["checks"] = shown
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        bench = _spec.load_benchmark()
        workload = {w["name"]: w for w in bench["workloads"]}[args.workload]
    except (FileNotFoundError, KeyError) as err:
        print(f"abm_bench: {err!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"abm_bench: the cell needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    found = forbidden_modules()
    if found:
        print(f"abm_bench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
