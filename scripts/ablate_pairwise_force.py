#!/usr/bin/env python3
"""What sets the time of the pairwise_force kernel, on one NVIDIA GPU: an
ablation at the spheroid_dense path's shape.

Run from the root of a checkout:

    python3 scripts/ablate_pairwise_force.py [--earlier-tree DIR]

It drives ``chip_smoke.py``'s spheroid path once and takes the dense
candidates of its final state, sorted as the next step would sort it (the
inputs of ``chip_smoke.py``'s pairwise_force row: 131,072 rows, K = 27 x 96).
Then it builds text-edited variants of
``kernels/pairwise_force/csrc/pairwise_force.cu`` (one ``nvcc`` each,
started together) under ``build/ablate_pairwise_force/`` and times each
(CUDA events, 3 x 20 calls after a warm-up, and 20 calls replayed from a
CUDA graph), all in this process:

  stream      the mask words loaded and their set bits counted, nothing
              queued
  compact     + the set slots ranked and queued in shared memory, none
              evaluated
  gather      + the queued slots' ids and their sources loaded, a pair adds
              the loaded values instead of the Eq 4.1 arithmetic
  kernel      + the arithmetic: the kernel as it is
  depth1, depth2, depth8, chunk2, chunk3, threads128
              other batch depths, mask words a lane loads at once and block
              sizes (same result as the kernel)
  minblocks5, minblocks6
              ``__launch_bounds__`` asking for 5 or 6 resident blocks a
              multiprocessor (fewer registers a thread; same result)

With ``--earlier-tree DIR`` (a checkout whose ``pairwise_force.cu`` is the
earlier design: a warp a row, a lane a slot mod 32, one byte load a slot),
also that kernel and two cuts of it, for its two suspected costs:

  earlier       the earlier kernel as it is
  earlier_mask  only its serial byte loads of the mask (a set slot adds 1)
  earlier_ids   + the id load of each set slot (no gathers, no arithmetic)

Prints one JSON line per variant, then the inputs' sizes and the card's name
and power limit.  The cut variants compute something else: their times only
say what each part costs.  Each keeps every index in bounds: queue indices
stay masked by the ring's size, and ids are loaded only for set slots.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate_pairwise_force"
SOURCE = ROOT / "src/repro_torch/kernels/pairwise_force/csrc/pairwise_force.cu"

EVAL_BODY = (r"  int id\[kDepth\];.*?add_pair\(qx, qy, qz, qr, sx\[d\], sy\[d\], sz\[d\], "
             r"sr\[d\], k, gamma, fx, fy, fz\);\n  \}\n")
ENQUEUE_SEGMENT = (r"enqueue\(bits\[0\], head \+ 16 \* \(w0 \+ 32 \* s \+ lane\), lane, queue, "
                   r"produced\);")
PAIR = r"add_pair\(qx, qy, qz, qr, sx\[d\], sy\[d\], sz\[d\], sr\[d\], k, gamma, fx, fy, fz\);"

# name -> [(regex, replacement)] on this checkout's source
VARIANTS = {
    "stream": [(ENQUEUE_SEGMENT, "fx += __popc(bits[0]);")],
    "compact": [(EVAL_BODY,
                 "  if (first + lane < last) fx += queue[(first + lane) & (kRing - 1)];\n")],
    "gather": [(PAIR, "fx += sx[d] + sy[d] + sz[d] + sr[d];")],
    "kernel": [],
    "depth1": [(r"kDepth = 4;", "kDepth = 1;")],
    "depth2": [(r"kDepth = 4;", "kDepth = 2;")],
    "depth8": [(r"kDepth = 4;", "kDepth = 8;")],
    "chunk2": [(r"kChunkWords = 6;", "kChunkWords = 2;")],
    "chunk3": [(r"kChunkWords = 6;", "kChunkWords = 3;")],
    "threads128": [(r"kThreads = 256;", "kThreads = 128;")],
    "minblocks5": [(r"__launch_bounds__\(kThreads\)", "__launch_bounds__(kThreads, 5)")],
    "minblocks6": [(r"__launch_bounds__\(kThreads\)", "__launch_bounds__(kThreads, 6)")],
}
SAME_AS_KERNEL = ("depth1", "depth2", "depth8", "chunk2", "chunk3", "threads128", "minblocks5",
                  "minblocks6")
# The earlier design's loop body, from its id load to its last add.
EARLIER_AFTER_ID = r"const float sr = src_rad\[j\];.*?fz = __fadd_rn\(fz, __fmul_rn\(scale, dzc\)\);"
EARLIER_VARIANTS = {
    "earlier": [],
    "earlier_mask": [(r"const int j = ids\[t\];.*?fz = __fadd_rn\(fz, __fmul_rn\(scale, dzc\)\);",
                   "fx += 1.f;")],
    "earlier_ids": [(EARLIER_AFTER_ID, "fx += j;")],
}


def build_all(nvcc: str, flags, sources: dict) -> dict:
    """``sources``: name -> (source text, edits).  One nvcc each, together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, edits) in sources.items():
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text, flags=re.S)
            if n != 1:
                raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
        cu, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = (lib, [ln.strip() for ln in out.splitlines() if "registers" in ln])
    return libs


def dense_inputs(cs):
    """The spheroid's final state, sorted, and its dense candidates."""
    from repro_torch.core.grid import build_index, candidate_neighbors_arrays, sort_agents

    built, final, *_ = cs.phase_spheroid()
    spec = built.config.spec
    pool = sort_agents(spec, final.pool)
    index = build_index(spec, pool, assume_sorted=True)
    cand, mask = candidate_neighbors_arrays(spec, index, pool.position, pool.alive)
    return pool.position, pool.radius(), cand, mask


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier-tree", help="a checkout holding the earlier pairwise_force.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_pairwise_force: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise_force import kernel as pf_k

    text = SOURCE.read_text()
    sources = {name: (text, edits) for name, edits in VARIANTS.items()}
    if args.earlier_tree:
        old = (Path(args.earlier_tree) / SOURCE.relative_to(ROOT)).read_text()
        sources.update({name: (old, edits) for name, edits in EARLIER_VARIANTS.items()})
    libs = build_all(_build.nvcc_path(), _build.NVCC_FLAGS, sources)
    pos, rad, cand, mask = dense_inputs(cs)
    n, kdim = cand.shape
    results = {}
    for name, (path, ptxas) in libs.items():
        fn = ctypes.CDLL(str(path)).pairwise_force_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name):
            out = torch.empty((n, 3), dtype=torch.float32, device="cuda")
            _build.check(fn(0, pos.data_ptr(), rad.data_ptr(), cand.data_ptr(),
                            mask.data_ptr(), pos.data_ptr(), rad.data_ptr(), n, kdim, 2.0,
                            1.0, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                         name)
            return out

        results[name] = call()
        torch.cuda.synchronize()
        print(json.dumps({"variant": name, "ms": [cs.cuda_ms(call, 20) for _ in range(3)],
                          "device_ms": cs.graph_ms(call, 20), "ptxas": ptxas}), flush=True)
    same = {name: bool(torch.equal(results[name], results["kernel"]))
            for name in SAME_AS_KERNEL}
    design = pf_k.design_bytes(mask)
    print(json.dumps({"same_result_as_the_kernel": same, "rows": n, "k": kdim,
                      "masked_in_slots": int(mask.sum()),
                      "live_rows": int(mask.any(1).sum()), "design_bytes": design,
                      "design_bound_ms": cs.bound(design, 12 * int(mask.sum()))["bound_ms"]}),
          flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
