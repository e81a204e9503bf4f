#!/usr/bin/env python3
"""Where the time of the port's paths goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/profile_torch_slice.py [--model soma|spheroid|spheroid_dense|
                                                    batch_sweep|sweep_slot|distributed|
                                                    lm_prefill|lm_decode|train]
                                           [--steps 6] [--trace trace.json]
                                           [--tree DIR]

Builds one path of ``chip_smoke.py``: ``soma`` (600,000 agents in 100^3
boxes, two 200^3 substances, cell_rank + cell_list_force + diffusion3d),
``spheroid`` (the 100,000-cell tumor spheroid sorted every step, forces by
cell_window_force at the covering window W), ``spheroid_dense`` (the same
start, forces by pairwise_force), ``batch_sweep`` (``chip_smoke.py``'s
sweep: 8 slots of 75,000 soma agents stepped by the batch engine, one step =
one batched step of all 8), ``sweep_slot`` (one of those slots run solo), ``distributed`` (the soma
model through ``Simulation.distribute`` on ``chip_smoke.py``'s 2 x 2 mesh of
four ranks on the card, one step = one lock-step iteration of all four),
``lm_prefill`` (phi4-mini-3.8b at full
width, one step = one prefill call over 4 x 2,048 tokens, flash_attention +
rmsnorm) or ``lm_decode`` (the same model, one step = one ``decode_step``
for a batch of 4 at positions from 128 on, rmsnorm) or ``train``
(``chip_smoke.py``'s training cell: phi4-mini at its published widths and
16 of 32 layers, one step = one ``make_train_step`` over 2 x 2,048 tokens,
with remat: the flash and rmsnorm kernels in the forward and the recomputed
forward, the plain attention backward, AdamW).  ``--tree DIR`` runs
another checkout's ``repro_torch`` (its kernels built there) under this
script's measurement, so that two checkouts can be compared in one call.
Runs a few steps to warm up, times ``--steps`` steps without the profiler
(host clock around ``torch.cuda.synchronize()``: the window's mean, and each
step with a synchronize after it, and their median), then the same number
of steps under ``torch.profiler``.  Prints one JSON line: the card and its
power limit, the step times, the device's busy time per step (the union of
kernel and copy intervals) and idle share, the kernels and copies per step,
the top device consumers by name, and the host's time per step split from
the profiler's CPU-side CUDA runtime events: in launch calls
(``cudaLaunchKernel``, ``cudaMemsetAsync``), blocked in syncs and
device-to-host copies (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaMemcpyAsync``), and the remainder, Python and the framework's own
host code, with every runtime call's count and time by name.  For the agent paths also the device activities of one
``cell_rank`` call on the path's cell ids, from a trace of ten calls; for
``spheroid_dense`` the device time of one dense candidate build on the
path's state by op, and its share of a step's busy time (the step builds the
candidates once).  The profiler's own overhead lengthens the profiled
window, so the idle share and the remainder are upper bounds.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def make_runner(cs, model: str, steps: int):
    """``run(n)``: advance the chosen path by ``n`` steps."""
    if model.startswith("lm_"):
        return lm_runner(cs, model, steps)
    if model == "train":
        return train_runner(cs)
    if model in ("batch_sweep", "sweep_slot"):
        return sweep_runner(cs, model)
    if model == "distributed":
        dsim = cs.dist_soma()
        dstate = [dsim.state]

        def run(n):
            dstate[0], _ = dsim.run(n, state=dstate[0])

        return run
    if model == "soma":
        built = cs.soma_model(cs.N_AGENTS, cs.SPACE, cs.RESOLUTION, 0, "cuda").build()
        state = [built.state]
    else:
        morton, dense, start, _, _ = cs.spheroid_setup()
        built = (morton if model == "spheroid" else dense).build()
        state = [start]

    def run(n):
        state[0], _ = built.run(n, state=state[0])

    def rank_input():
        from repro_torch.core.grid import _live_cell_ids

        spec, pool = built.config.spec, state[0].pool
        return _live_cell_ids(spec, pool.position, pool.alive), spec.n_cells

    def candidate_build():
        """A call that builds the dense candidates of the path's state, as
        the step does after its sort."""
        from repro_torch.core.grid import build_index, candidate_neighbors_arrays, sort_agents

        spec = built.config.spec
        pool = sort_agents(spec, state[0].pool)
        index = build_index(spec, pool, assume_sorted=True)
        return lambda: candidate_neighbors_arrays(spec, index, pool.position, pool.alive)

    run.rank_input = rank_input
    if model == "spheroid_dense":
        run.candidate_build = candidate_build
    return run


def activities(fn, calls: int = 10):
    """Device activities (kernels, memsets, copies) per call of ``fn()``,
    from a trace of ``calls`` calls alone: their count, their names and
    their device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = collections.Counter()
    us = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name[:60]] += 1
            us[e.name[:60]] += e.time_range.end - e.time_range.start
    return {"per_call": sum(names.values()) / calls,
            "device_ms_per_call": sum(us.values()) / 1e3 / calls,
            "names": {k: v / calls for k, v in sorted(names.items())},
            "us_per_call": {k: us[k] / calls for k in sorted(names)}}


# CPU-side CUDA runtime calls, by what they cost the host.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemsetAsync")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")


def host_split(prof, window_us: float, steps: int) -> dict:
    """The host's time per step in launch calls, blocked in syncs and
    device-to-host copies, and the rest (Python and the framework), from the
    CUDA runtime events of a profiled window; each class as the union of its
    intervals."""
    by_name = collections.defaultdict(lambda: [0, 0.0])
    launch, sync = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        name = e.name
        if not name.startswith("cuda"):
            continue
        span = (e.time_range.start, e.time_range.end)
        by_name[name][0] += 1
        by_name[name][1] += span[1] - span[0]
        if name in LAUNCH_CALLS:
            launch.append(span)
        elif name in SYNC_CALLS:
            sync.append(span)
    launch_us, sync_us = busy_us(launch), busy_us(sync)
    return {
        "launch_ms_per_step": launch_us / 1e3 / steps,
        "sync_and_copy_ms_per_step": sync_us / 1e3 / steps,
        "python_and_framework_ms_per_step": (window_us - busy_us(launch + sync)) / 1e3 / steps,
        "runtime_calls": {name: {"per_step": n / steps, "ms_per_step": us / 1e3 / steps}
                          for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])},
    }


def sweep_runner(cs, model: str):
    """``chip_smoke.py``'s batch_sweep (seeds 100.., substance_1 from 0 to
    3.5): the whole batch, or its first slot alone."""
    import numpy as np

    built = cs.sweep_model().build()
    eng = built.batched()
    params = {"substance:substance_1":
              np.linspace(0.0, 3.5, cs.SWEEP_SLOTS).astype(np.float32)}
    bstate = [eng.sweep_state(seeds=[100 + b for b in range(cs.SWEEP_SLOTS)],
                              params=params)]
    state = [eng.session_state(seed=100, params={k: v[0] for k, v in params.items()})]

    def run(n):
        if model == "batch_sweep":
            bstate[0] = eng.run(bstate[0], n)[0]
        else:
            state[0], _ = built.run(n, state=state[0])

    return run


def lm_runner(cs, model: str, steps: int):
    from repro_torch.training import make_decode_step, make_prefill_step

    lm = cs.lm_model(reduced=False)
    params = lm.init(0, device="cuda", dtype=lm.compute_dtype)
    vocab = lm.cfg.vocab_size
    if model == "lm_prefill":
        toks = cs.lm_tokens(cs.LM_BATCH, cs.LM_PREFILL_LEN, vocab, 1).cuda()
        step = make_prefill_step(lm)

        def run(n):
            for _ in range(n):
                step(params, {"tokens": toks})

        return run
    start = cs.LM_SERVE_PROMPT
    cache = lm.init_cache(cs.LM_BATCH, start + 4 + 3 * steps, "cuda")
    toks = cs.lm_tokens(cs.LM_BATCH, 4 + 3 * steps, vocab, 2).cuda()
    step = make_decode_step(lm)
    done = [0]

    def run(n):
        for _ in range(n):
            i = done[0]
            step(params, cache, toks[:, i:i + 1], start + i)
            done[0] += 1

    return run


def train_runner(cs):
    from repro_torch import training
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.optim import adamw

    model = cs.train_model(reduced=False)
    state = [training.init_train_state(model, 0, "cuda")]
    data = DataConfig(seed=0, batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_LEN)
    batch = device_batch(data, model.cfg, 0, "cuda")
    step = training.make_train_step(model, adamw.AdamWConfig())

    def run(n):
        for _ in range(n):
            state[0], _ = step(state[0], batch)

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("soma", "spheroid", "spheroid_dense", "batch_sweep",
                                        "sweep_slot", "distributed", "lm_prefill",
                                        "lm_decode", "train"),
                    default="soma")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose repro_torch runs (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    import repro_torch

    run = make_runner(cs, args.model, args.steps)
    run(4)                                          # warm-up: builds the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(args.steps)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    each_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run(1)
        torch.cuda.synchronize()
        each_ms.append(1e3 * (time.perf_counter() - t0))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device)
    copies = sum(n for name, (n, _) in by_name.items() if "memcpy" in name.lower())
    dtoh = sum(n for name, (n, _) in by_name.items()
               if "memcpy" in name.lower() and "dtoh" in name.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    extra = {}
    if hasattr(run, "rank_input"):
        from repro_torch.kernels.cell_rank import kernel as cr_k

        cid, n_cells = run.rank_input()
        extra["cell_rank_activities"] = activities(lambda: cr_k.cell_rank_cuda(cid, n_cells))
    if hasattr(run, "candidate_build"):
        build = activities(run.candidate_build())
        build["share_of_step_busy"] = build["device_ms_per_call"] / (busy / 1e3 / args.steps)
        extra["candidate_build"] = build
    print(json.dumps({
        "model": args.model,
        "tree": args.tree,
        "module": repro_torch.__file__,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi_line(),
        "steps": args.steps,
        "step_ms": step_ms,
        "median_step_ms": statistics.median(each_ms),
        "each_step_ms": each_ms,
        "profiled_step_ms": window_us / 1e3 / args.steps,
        "host": host_split(prof, window_us, args.steps),
        "device_busy_ms_per_step": busy / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy / window_us,
        "device_activities_per_step": len(device) / args.steps,
        "copies_per_step": copies / args.steps,
        "device_to_host_copies_per_step": dtoh / args.steps,
        "top": [{"name": name[:90], "per_step": n / args.steps,
                 "ms_per_step": us / 1e3 / args.steps} for name, (n, us) in top],
        **extra,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
