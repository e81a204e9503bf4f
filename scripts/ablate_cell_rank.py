#!/usr/bin/env python3
"""Where the time of the cell_rank kernel goes, on one NVIDIA GPU: its three
passes timed at the soma and spheroid paths' shapes, with parts cut out.

Run from the root of a checkout:

    python3 scripts/ablate_cell_rank.py

Inputs are made from a seed at the paths' sizes: 600,000 agents over 10^6
cells, 5% of them dead (soma: ids uniform, as an unsorted pool gives them),
and 131,072 agents over 175,616 cells, 100,000 of them live (spheroid).
Builds text-edited variants of ``kernels/cell_rank/csrc/cell_rank.cu`` (one
``nvcc`` each, started together) under ``build/ablate_cell_rank/``:

  kernel      the kernel as it is
  no_fill     the fill blocks that have agents to place wait for the
              buckets and stop there
  no_table    the rank pass reads no table row (cells of 2-4 agents rank 0)
  no_ticket   pass 2's blocks take blockIdx as their ticket
  no_count_atomic  the count pass makes no atomics (every slot 0)

For each variant and shape: the device time of each activity of a call (the
profiler over 20 calls) and of the whole call (20 calls replayed from a CUDA
graph), and for the kernel whether the ranks equal a stable-sort oracle.
Prints one JSON line per variant and the card's name and power limit.  The
cut variants compute something else: their times only say what each part
costs.  Each keeps every index in bounds on these inputs (no crowded cell:
the crowded-cell blocks would index ranks by bucket entries).
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate_cell_rank"
VARIANTS = {
    "kernel": [],
    "no_fill": [(r"(  block_wait\(&counters\[kPlaced\], static_cast<int>\(tiles_c\)\);\n)",
                 r"\1  if (n >= 0) return;\n")],
    "no_table": [(r"r\[k\] = \(row\.x < i\) \+ \(row\.y < i\) \+ \(m\[k\] > 2 && row\.z < i\) \+ "
                  r"\(m\[k\] > 3 && row\.w < i\);", "r[k] = 0;")],
    "no_ticket": [(r"ticket = atomicAdd\(&counters\[kTicket\], 1\);", "ticket = blockIdx.x;")],
    "no_count_atomic": [(r"\? atomicAdd\(&count\[c\[k\]\], __popc\(group\[k\]\)\)", "? 0")],
}


def build_all(nvcc: str, flags) -> dict:
    src = (ROOT / "src/repro_torch/kernels/cell_rank/csrc/cell_rank.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text)
            assert n == 1, (name, pattern)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
    return libs


def inputs():
    g = torch.Generator(device="cuda").manual_seed(0)
    soma_cells, sph_cells = 100**3, 56**3
    soma = torch.randint(0, soma_cells, (600_000,), generator=g, device="cuda")
    soma[torch.rand(600_000, generator=g, device="cuda") < 0.05] = soma_cells
    sph = torch.full((131_072,), sph_cells, device="cuda", dtype=torch.long)
    sph[:100_000] = torch.randint(0, sph_cells, (100_000,), generator=g, device="cuda")
    return {"soma": (soma.int(), soma_cells), "spheroid": (sph.int(), sph_cells)}


def oracle(cid: torch.Tensor, n_cells: int) -> torch.Tensor:
    order = torch.sort(cid, stable=True).indices
    counts = torch.bincount(cid.long(), minlength=n_cells + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(cid)
    rank[order] = (torch.arange(cid.numel(), device=cid.device)
                   - starts[cid.long()[order]]).int()
    return rank


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_cell_rank: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.cell_rank import kernel as cr_k

    libs = build_all(_build.nvcc_path(), [f for f in _build.NVCC_FLAGS
                                          if f not in ("-v", "-Xptxas")])
    shapes = inputs()
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).cell_rank_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        result = {"variant": name}
        for shape, (cid, n_cells) in shapes.items():
            def call(cid=cid, n_cells=n_cells):
                size = cr_k.workspace_bytes(cid.numel(), n_cells)
                work = torch.empty((size,), dtype=torch.uint8, device="cuda")
                rank = torch.empty_like(cid)
                _build.check(fn(0, cid.data_ptr(), cid.numel(), n_cells, work.data_ptr(),
                                size, rank.data_ptr(),
                                torch.cuda.current_stream().cuda_stream), name)
                return rank
            exact = bool(torch.equal(call(), oracle(cid, n_cells)))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            us = collections.Counter()
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    label = re.sub(r"^\(anonymous namespace\)::", "", e.name).split("(")[0]
                    us[label] += (e.time_range.end - e.time_range.start) / 20
            result[shape] = {"device_ms": cs.graph_ms(call, 20), "us_by_activity": dict(us),
                             "equals_oracle": exact}
        print(json.dumps(result), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
