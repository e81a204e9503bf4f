#!/usr/bin/env python3
"""Time one checkout's cell_rank and diffusion3d kernels on inputs made from
a seed, on one NVIDIA GPU, so that two checkouts can be compared in one call.

    python3 scripts/time_rank_diffusion.py [--tree DIR]

Imports ``repro_torch`` from the checkout at ``--tree`` (default: this one;
its kernels are built there, from its own sources) and times, at the soma
and spheroid paths' sizes:

  cell_rank   600,000 ids over 10^6 cells, 5% dead (soma: uniform, as an
              unsorted pool gives them); 131,072 ids over 175,616 cells,
              100,000 live (spheroid); 65,536 agents in one cell
  diffusion3d one step of a 200^3 float32 field

For each: ``ms``, CUDA events over back-to-back calls (the host's dispatch
included); ``device_ms``, the same calls replayed from a CUDA graph; and the
device activities of one call from a profiler trace; whether the ranks equal
a stable-sort oracle and the field the plain version, bit for bit.  Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import torch


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def activities(fn, calls: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = collections.Counter(e.name.split("(")[0][-40:] for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"per_call": sum(names.values()) / calls,
            "names": {k: v / calls for k, v in sorted(names.items())}}


def rank_oracle(cid: torch.Tensor, n_cells: int) -> torch.Tensor:
    order = torch.sort(cid, stable=True).indices
    counts = torch.bincount(cid.long(), minlength=n_cells + 1)
    rank = torch.empty_like(cid)
    rank[order] = (torch.arange(cid.numel(), device=cid.device)
                   - (torch.cumsum(counts, 0) - counts)[cid.long()[order]]).int()
    return rank


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose kernels run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_rank_diffusion: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels.cell_rank import kernel as cr_k
    from repro_torch.kernels.diffusion3d import kernel as d3_k
    from repro_torch.kernels.diffusion3d.ref import diffusion_step_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    soma_cells, sph_cells = 100**3, 56**3
    soma = torch.randint(0, soma_cells, (600_000,), generator=g, device="cuda")
    soma[torch.rand(600_000, generator=g, device="cuda") < 0.05] = soma_cells
    sph = torch.full((131_072,), sph_cells, device="cuda", dtype=torch.long)
    sph[:100_000] = torch.randint(0, sph_cells, (100_000,), generator=g, device="cuda")
    crowded = torch.full((65_536,), 4242, device="cuda", dtype=torch.int32)
    u = torch.rand((200, 200, 200), generator=g, device="cuda") * 10
    calls = {}   # name -> (call, reps, the result's check)
    for name, cid, n_cells, reps in (("cell_rank_soma", soma.int(), soma_cells, 50),
                                     ("cell_rank_spheroid", sph.int(), sph_cells, 50),
                                     ("cell_rank_crowded_box", crowded, soma_cells, 5)):
        call = lambda cid=cid, n_cells=n_cells: cr_k.cell_rank_cuda(cid, n_cells)
        calls[name] = (call, reps, lambda call=call, cid=cid, n_cells=n_cells: {
            "exact": bool(torch.equal(call(), rank_oracle(cid, n_cells)))})
    step = lambda: d3_k.diffusion_step_cuda(u, 0.16, 0.002)
    calls["diffusion3d_200"] = (step, 50, lambda: {"bit_identical_to_plain": bool(
        torch.equal(step(), diffusion_step_ref(u, 0.16, 0.002)))})
    result = {"tree": args.tree, "module": cr_k.__file__}
    # Event times first: a profiler session leaves the host slower after it.
    for name, (call, reps, check) in calls.items():
        result[name] = {**check(), "ms": events_ms(call, reps)}
    for name, (call, reps, _) in calls.items():
        result[name]["device_ms"] = graph_ms(call, min(reps, 20))
    for name, (call, _, _) in calls.items():
        result[name]["activities"] = activities(call)
    result["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
