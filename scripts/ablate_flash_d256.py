#!/usr/bin/env python3
"""What sets the time of the D 256 tensor-core flash kernel, on one NVIDIA
GPU: an ablation at the two family shapes that run it.

Run from the root of a checkout:

    python3 scripts/ablate_flash_d256.py

It builds variants of ``csrc/flash_attention_wgmma_d256.cu`` in which one
part of the design is changed or cut out by a text edit (all nvcc processes
started together), runs each through the port's wrapper on bf16 inputs from
a seed at paligemma-3b's prefill call (B 4, 8 / 1 heads, T 2,304, D 256,
causal, prefix 256) and recurrentgemma-9b's (B 2, 16 / 1, T 4,096, window
2,048), in the model's (B, T, H, D) layout, and times each (CUDA events, 3 x
20 calls after a warm-up, the variants in turns):

  kernel        the kernel as it is
  pv_m64n128    the first design: a warpgroup's P V over its 128 columns in
                one m64n128 accumulator (same result)
  stages2       2 stages of K and V instead of 3 (same result)
  one_p_term    P V of the hi term of P only (two of the three products cut)
  half_s        S over half of D (8 of the 16 steps): what the redundant S
                costs
  no_pv         no P V product (the accumulators stay 0)
  loads_only    the consumers wait for each tile and release it at once: the
                TMA pipeline and the block schedule alone

Prints one JSON line a variant (its ptxas spill line, whether its outputs
equal the kernel's, its times) and the card's name and power limit.  The cut
variants compute something else: their times only say what each part costs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate_flash_d256"

PV_TWO_STEPS_START = "#pragma unroll\n      for (int half = 0; half < 2; ++half) {"
PV_TWO_STEPS_END = "      if (lane == 0) mbar_arrive(bar_empty + 8 * s);"
PV_ONE_STEP = """      float pv[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_sw128(v_cols + s * kTile + kk * 16 * 128, kPanelBytes, 1024);
        wgmma_m64n128k16_rs(pv, a_lo[kk], dv, kk > 0 ? 1 : 0);
        wgmma_m64n128k16_rs(pv, a_mid[kk], dv, 1);
        wgmma_m64n128k16_rs(pv, a_hi[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], pv[i]);
"""
M64N128_RS = """__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %69, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" REGS "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\\n}\\n"
      : OUTS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

""".replace('" REGS "', ", ".join(f"%{i}" for i in range(64))).replace(
    "OUTS", ", ".join(f'"+f"(d[{i}])' for i in range(64)))
CONSUMER_WAIT = "      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);\n"


def pv_m64n128(src: str) -> str:
    i0, i1 = src.index(PV_TWO_STEPS_START), src.index(PV_TWO_STEPS_END)
    src = src[:i0] + PV_ONE_STEP + src[i1:]
    return src.replace("__device__ __forceinline__ float ex2(", M64N128_RS +
                       "__device__ __forceinline__ float ex2(", 1)


def no_pv(src: str) -> str:
    i0 = src.index("#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {\n          const uint64_t dv")
    i1 = src.index("        wgmma_commit();", i0)
    return src[:i0] + "        for (int i = 0; i < 32; ++i) pv[i] = 0.f;\n" + src[i1:]


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"ablate_flash_d256: the source no longer holds {old!r}")
    return src.replace(old, new)


VARIANTS = {
    "kernel": lambda s: s,
    "pv_m64n128": pv_m64n128,
    "stages2": lambda s: edit(s, "kStages = 3;", "kStages = 2;"),
    "one_p_term": lambda s: edit(edit(edit(
        s, "          wgmma_m64n64k16_rs(pv, a_lo[kk], dv, kk > 0 ? 1 : 0);\n", ""),
        "          wgmma_m64n64k16_rs(pv, a_mid[kk], dv, 1);\n", ""),
        "wgmma_m64n64k16_rs(pv, a_hi[kk], dv, 1);", "wgmma_m64n64k16_rs(pv, a_hi[kk], dv, kk > 0);"),
    "half_s": lambda s: edit(s, "for (int kk = 0; kk < kD / 16; ++kk) {",
                             "for (int kk = 0; kk < kD / 32; ++kk) {"),
    "no_pv": no_pv,
    "loads_only": lambda s: edit(s, CONSUMER_WAIT, CONSUMER_WAIT +
                                 "      if (lane == 0) mbar_arrive(bar_empty + 8 * s);\n"
                                 "      ++it;\n      continue;\n"),
}
SAME_AS_KERNEL = ("pv_m64n128", "stages2")
SHAPES = {   # name: ((B, Hq, Hkv, T), mask kwargs)
    "paligemma": ((4, 8, 1, 2304), dict(causal=True, prefix_len=256)),
    "recurrentgemma": ((2, 16, 1, 4096), dict(causal=True, window=2048)),
}


def cuda_ms(fn, reps: int) -> float:
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
        print("ablate_flash_d256: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k

    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["flash_attention_wgmma_d256"].read_text()
    names = {}
    for v, fn in VARIANTS.items():
        path = OUT / f"flash_d256_{v}.cu"
        path.write_text(fn(src))
        names[v] = f"flash_d256_{v}"
        _build.SOURCES[names[v]] = path
    built = _build.build(names.values())
    launcher = fa_k.TC_KERNELS[256][1]

    g = torch.Generator().manual_seed(0)
    inputs = {}
    for shape, ((b, hq, hkv, t), kw) in SHAPES.items():
        q, k, v = (torch.randn(s, generator=g).bfloat16().cuda().transpose(1, 2)
                   for s in ((b, t, hq, 256), (b, t, hkv, 256), (b, t, hkv, 256)))
        inputs[shape] = (q, k, v, kw)

    def run(v, shape):
        fa_k.TC_KERNELS[256] = (names[v], launcher)
        q, k, v_, kw = inputs[shape]
        return lambda: fa_k.flash_attention_wgmma_cuda(q, k, v_, **kw)

    want = {shape: run("kernel", shape)() for shape in SHAPES}
    rows = {}
    for v in VARIANTS:
        rows[v] = {"variant": v, "ptxas": [ln.strip() for ln in built[names[v]].ptxas.splitlines()
                                           if "spill" in ln or "registers" in ln]}
        for shape in SHAPES:
            rows[v][f"{shape}_same_as_kernel"] = bool(torch.equal(run(v, shape)(), want[shape]))
            rows[v][f"{shape}_ms"] = []
    for _ in range(3):
        for v in VARIANTS:
            for shape in SHAPES:
                rows[v][f"{shape}_ms"].append(cuda_ms(run(v, shape), 20))
    for v in VARIANTS:
        if v in SAME_AS_KERNEL and not all(rows[v][f"{s}_same_as_kernel"] for s in SHAPES):
            raise AssertionError(f"ablate_flash_d256: {v} should equal the kernel")
        print(json.dumps(rows[v]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
