#!/usr/bin/env python3
"""The diffusion stencil's tile, ring depth and grid cut, timed on one NVIDIA
GPU at the soma path's field shape (200^3 float32).

Run from the root of a checkout:

    python3 scripts/ablate_diffusion.py

Builds variants of ``kernels/diffusion3d/csrc/diffusion3d.cu`` that differ
only in the constants kTy x kTz (the block's output tile in y and z),
kStages (the ring of staged planes; kStages - 3 in flight) and kBlocksPerSm
(how finely the launcher cuts x into runs), one ``nvcc`` each, started
together, under ``build/ablate_diffusion/``, and times each with CUDA events
over 3 x 50 calls after a warm-up, its output held to the plain version bit
for bit.  Also times ``clone()`` of the field, the
card's streaming copy of the same bytes, as a yardstick.  Prints one JSON
line per variant and the card's name and power limit.
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
OUT = ROOT / "build" / "ablate_diffusion"
SHAPE = (200, 200, 200)
NU, DECAY = 0.16, 0.002
VARIANTS = {  # name -> (kTy, kTz, kStages)
    "16x32_ring6": (16, 32, 6),
    "8x64_ring6": (8, 64, 6),
    "16x64_ring6": (16, 64, 6),
    "8x32_ring6": (8, 32, 6),
    "4x128_ring6": (4, 128, 6),
    "16x32_ring4": (16, 32, 4),
    "16x32_ring8": (16, 32, 8),
}
BLOCKS_PER_SM = (2, 4, 8, 16)


def build_all(nvcc: str, flags) -> dict:
    """``(variant, blocks a multiprocessor) -> library``."""
    src = (ROOT / "src/repro_torch/kernels/diffusion3d/csrc/diffusion3d.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (name, (ty, tz, stages)), per_sm in ((v, b) for v in VARIANTS.items()
                                             for b in BLOCKS_PER_SM):
        text = src
        for const, value in (("kTy", ty), ("kTz", tz), ("kStages", stages),
                             ("kBlocksPerSm", per_sm)):
            text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                              text)
            assert n == 1, const
        cu = OUT / f"{name}_{per_sm}.cu"
        cu.write_text(text)
        lib = OUT / f"{name}_{per_sm}.so"
        procs[name, per_sm] = (subprocess.Popen([nvcc, *flags, "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
    return libs


def events_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_diffusion: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.diffusion3d.ref import diffusion_step_ref

    libs = build_all(_build.nvcc_path(), [f for f in _build.NVCC_FLAGS if f != "-v"
                                          and f != "-Xptxas"])
    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand(SHAPE, generator=g, device="cuda") * 10
    out = torch.empty_like(u)
    want = diffusion_step_ref(u, NU, DECAY)
    nu, keep = float(np.float32(NU)), float(np.float32(1.0 - DECAY))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    print(json.dumps({"variant": "clone", "ms": [events_ms(lambda: u.clone())
                                                 for _ in range(3)]}), flush=True)
    for name in VARIANTS:
        times = {}
        for per_sm in BLOCKS_PER_SM:
            fn = ctypes.CDLL(str(libs[name, per_sm])).diffusion3d_launch
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            call = lambda: _build.check(fn(0, u.data_ptr(), out.data_ptr(), 1, *SHAPE, nu,
                                           keep, stream), name)
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} at {per_sm} blocks a multiprocessor differs "
                                     f"from the plain version")
            times[per_sm] = [events_ms(call) for _ in range(3)]
        print(json.dumps({"variant": name, "tile_y_z_ring": VARIANTS[name],
                          "ms_by_blocks_per_sm": times}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
