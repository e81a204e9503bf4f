#!/usr/bin/env python3
"""What sets the time of the two cell-force kernels, on one NVIDIA GPU: an
ablation at the main paths' shapes.

Run from the root of a checkout:

    python3 scripts/ablate_force_kernels.py

It drives ``chip_smoke.py``'s soma and spheroid paths once to get their
final states (the soma cell list; the spheroid's sorted pool and covering
window), saves them under ``build/ablate/``, then builds variants of
``csrc/cell_window_force.cu`` and ``csrc/cell_list_force.cu`` in which one
part of the work is cut out by a text edit, and times each one (CUDA events,
3 x 20 calls after a warm-up), each in a process of its own:

  window          the kernel as it is
  window_noarith  the walk reads each candidate row's cell id, but a kept
                  pair adds 1 instead of the Eq 4.1 arithmetic (no position
                  reads)
  window_nowalk   the span table, the 27 clipped intervals and their
                  selection, but no row of an interval is read
  window_threads64 / window_threads256
                  other block sizes (same result)
  list            the kernel as it is
  list_noarith    a staged pair adds 1 instead of the arithmetic
  list_nocompute  count, scans and staging, but no query is walked
  list_threads128 128 threads a block (same result)
  list_tile4x4x8, list_tile2x4x32, list_tile8x8x8_2048, list_budget2048
                  other tile shapes and staging budgets of the kernel's
                  wrapper (``kernel.TILE``, ``kernel.STAGE_BUDGET``; same
                  result)

Prints one JSON line per variant and the card's name and power limit.  The
cut variants compute something else: their times only say what each part
costs.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate"
INPUTS = OUT / "inputs.pt"

WINDOW_ARITH = (r"const float sr = __ldg\(&rad\[r\]\);.*?"
                r"fz = __fadd_rn\(fz, __fmul_rn\(scale, dzc\)\);")
LIST_PAIR = (r"add_pair\(qa\.x, qa\.y, qa\.z, qa\.w, s_agent\[base \+ u\], k, gamma, "
             r"fx, fy, fz\);")
LIST_QUERIES = r"t < n_query; t \+= blockDim\.x"

# name -> (kernel, [(regex, replacement)], {kernel.py constant: value})
VARIANTS = {
    "window": ("cell_window_force", [], {}),
    "window_noarith": ("cell_window_force", [(WINDOW_ARITH, "fx += 1.f;")], {}),
    "window_nowalk": ("cell_window_force", [
        (r"for \(int r = start; r < end; \+\+r\) \{",
         "fx += end - start;\n      for (int r = end; r < end; ++r) {")], {}),
    "window_threads64": ("cell_window_force", [(r"kThreads = 128", "kThreads = 64")], {}),
    "window_threads256": ("cell_window_force", [(r"kThreads = 128", "kThreads = 256")], {}),
    "list": ("cell_list_force", [], {}),
    "list_noarith": ("cell_list_force", [(LIST_PAIR, "fx += 1.f;")], {}),
    "list_nocompute": ("cell_list_force", [(LIST_QUERIES, "t < 0; t += blockDim.x")], {}),
    "list_threads128": ("cell_list_force", [(r"kThreads = 256", "kThreads = 128")], {}),
    "list_tile4x4x8": ("cell_list_force", [], {"TILE": (4, 4, 8)}),
    "list_tile2x4x32": ("cell_list_force", [], {"TILE": (2, 4, 32)}),
    "list_tile8x8x8_2048": ("cell_list_force", [], {"TILE": (8, 8, 8), "STAGE_BUDGET": 2048}),
    "list_budget2048": ("cell_list_force", [], {"STAGE_BUDGET": 2048}),
}
SAME_AS = {"window_threads64": "window", "window_threads256": "window",
           "list_threads128": "list", "list_tile4x4x8": "list", "list_tile2x4x32": "list",
           "list_tile8x8x8_2048": "list", "list_budget2048": "list"}


def save_inputs() -> None:
    import chip_smoke as cs
    from repro_torch.core.grid import build_index, sort_agents

    built, final, *_ = cs.phase_slice()
    spec, pool = built.config.spec, final.pool
    index = build_index(spec, pool)
    sbuilt, sfinal, window, *_ = cs.phase_spheroid()
    sspec = sbuilt.config.spec
    spool = sort_agents(sspec, sfinal.pool)
    sindex = build_index(sspec, spool, assume_sorted=True)
    torch.save(dict(list_args=(pool.position, pool.radius(), index.cell_list, spec.dims),
                    num_out=pool.capacity,
                    window_args=(spool.position, spool.radius(), sindex.cell_of_agent,
                                 sspec.dims),
                    block=cs.SPH_BLOCK, half_window=window), INPUTS)


def time_variant(name: str) -> dict:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.cell_force import kernel as cf_k

    kernel, edits, constants = VARIANTS[name]
    src = _build.SOURCES[kernel].read_text()
    for pattern, repl in edits:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        if n == 0:
            raise RuntimeError(f"{name}: {pattern!r} not found in {kernel}.cu")
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    _build._LOADED[kernel] = ctypes.CDLL(str(so))
    for attr, value in constants.items():  # this process only
        setattr(cf_k, attr, value)
    d = torch.load(INPUTS, map_location="cuda:0")
    if kernel == "cell_window_force":
        call = lambda: cf_k.cell_window_force_cuda(*d["window_args"], block=d["block"],
                                                   half_window=d["half_window"])
    else:
        call = lambda: cf_k.cell_list_force_cuda(*d["list_args"], num_out=d["num_out"])
    out = call()
    torch.cuda.synchronize()
    torch.save(out.cpu(), OUT / f"{name}.pt")
    return dict(variant=name, ms=[cs.cuda_ms(call, 20) for _ in range(3)])


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_force_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if sys.argv[1:2] == ["--variant"]:
        print(json.dumps(time_variant(sys.argv[2])), flush=True)
        return 0
    if sys.argv[1:2] == ["--inputs"]:
        save_inputs()
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--inputs"], check=True, stdout=subprocess.DEVNULL)
    # One process a variant: each loads its own build of the same kernel.
    for name in VARIANTS:
        subprocess.run(me + ["--variant", name], check=True)
    same = {name: bool(torch.equal(torch.load(OUT / f"{name}.pt"),
                                   torch.load(OUT / f"{base}.pt")))
            for name, base in SAME_AS.items()}
    print(json.dumps({"same_result_as_the_kernel": same}))
    import chip_smoke as cs
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
