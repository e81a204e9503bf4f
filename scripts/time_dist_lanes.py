"""Time the distributed step of checkouts in turns on one card: eager, and
replayed from CUDA graphs under each schedule.

    python3 scripts/time_dist_lanes.py --tree A --tree B [--order ABBA] [--out FILE]

Each turn is a child process whose ``PYTHONPATH`` puts the tree's ``src/``
first, so each tree's own package steps the same model: ``chip_smoke.py``'s
``dist_soma`` (path 1's 600,000 soma agents on a 2x2 mesh of four ranks on
the card, from this checkout's ``chip_smoke.py``).  A turn prints one JSON
line:

* ``eager_step_ms``: ``EAGER_STEPS`` steps of ``DistributedStep.step_ranks``
  after ``WARMUP`` steps, each clocked on the host around
  ``torch.cuda.synchronize()``, and their median;
* for ``distributed_jit`` (int16 codec, serial), ``_int8`` and
  ``_overlap`` (``overlap_halo``): ``JIT_STEPS`` steps through
  ``run_jit`` three times from the deployment's state, the first capturing;
  ``step_ms`` = run seconds / steps of the other two (all replays), the
  peak memory of the capturing run, and from a ``torch.profiler`` trace of
  one replayed step ``rank_concurrency`` (``chip_smoke.replay_concurrency``);
* the lanes' events and waits an eager step, where the tree has lanes;
* the card's name and power limit (``nvidia-smi``).

The order (default ``ABBA``) alternates the trees so that a drift of the
card's clocks over the call falls on both.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, EAGER_STEPS, JIT_STEPS = 2, 10, 20
VARIANTS = (("distributed_jit", {}), ("distributed_jit_int8", {"codec": "int8"}),
            ("distributed_jit_overlap", {"overlap": True}))


def child(tree: str) -> dict:
    import torch

    sys.path.append(ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build(cs.DIST_KERNELS)
    try:
        from repro_torch.core import lanes
    except ImportError:
        lanes = None
    out = {"tree": tree, "nvidia_smi": cs.nvidia_smi_line(), "torch": torch.__version__}

    dsim = cs.dist_soma()
    ranks = dsim.step.unstack(dsim.state)
    times = []
    for i in range(WARMUP + EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks = dsim.step.step_ranks(ranks, i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["eager_step_ms"] = times[WARMUP:]
    out["eager_median_step_ms"] = statistics.median(times[WARMUP:])
    if lanes is not None:
        lanes.counts.reset()
        dsim.step.step_ranks(ranks, WARMUP + EAGER_STEPS)
        torch.cuda.synchronize()
        out["lane_events_a_step"] = lanes.counts.events
        out["lane_waits_a_step"] = lanes.counts.waits
    del dsim, ranks
    torch.cuda.empty_cache()

    for name, kw in VARIANTS:
        dsim = cs.dist_soma(**kw)
        runs = []
        for i in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dsim.run_jit(JIT_STEPS)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, torch.cuda.max_memory_allocated()))
        stats = dsim._jitted.stats
        if stats["rollbacks"]:
            raise AssertionError(f"{name}: a rollback: {stats}")
        conc = cs.replay_concurrency(dsim)
        out[name] = dict(step_ms=[1e3 * s / JIT_STEPS for s, _ in runs[1:]],
                         capture_run_peak_bytes=runs[0][1], runner=dict(stats),
                         **{k: v for k, v in conc.items() if not isinstance(v, dict)})
        del dsim
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.tree[0])))
        return 0
    trees = [os.path.abspath(t) for t in args.tree]
    results = []
    for letter in args.order:
        tree = trees[ord(letter) - ord("A")]
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               "--tree", tree], env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
