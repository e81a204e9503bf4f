#!/usr/bin/env python3
"""Time the tensor-core flash-attention kernel of two checkouts in turns,
on one NVIDIA GPU.

    python3 scripts/time_flash_trees.py --tree A --tree B [--rounds 2]

Runs the kernel of each tree in its own process (both packages are named
``repro_torch``), in the order A, B, B, A for two rounds, each process
building that tree's ``flash_attention_wgmma.cu`` and timing it at the LM
prefill shape (B 4, 24 / 8 heads, T 2,048, D 128, causal, bf16, the
model's (B, T, H, D) storage seen as (B, H, T, D)): the CUDA-event mean of
20 launches after a warm-up, and the largest difference to the first
tree's output on the same seeded inputs.  One JSON line a run, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (4, 24, 8, 2048, 128)      # B, Hq, Hkv, T, D

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_k
_build.build(["flash_attention_wgmma"])
b, hq, hkv, t, d = %(shape)r
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn((b, t, h, d), generator=g).bfloat16().cuda().transpose(1, 2)
           for h in (hq, hkv, hkv))
fn = lambda: fa_k.flash_attention_wgmma_cuda(q, k, v, causal=True)
out = fn()
torch.cuda.synchronize()
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(20):
    fn()
end.record()
end.synchronize()
torch.save(out.cpu(), sys.argv[2])
print(json.dumps({"ms": start.elapsed_time(end) / 20}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="build/flash_trees")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_flash_trees: no CUDA device is available", file=sys.stderr)
        return 1
    trees = [str(Path(t).resolve()) for t in args.tree]
    order = (trees + trees[::-1]) * args.rounds
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    first = None
    for i, tree in enumerate(order):
        dump = out_dir / f"out_{i}.pt"
        proc = subprocess.run([sys.executable, "-c", CHILD % {"shape": SHAPE}, tree, str(dump)],
                              capture_output=True, text=True, timeout=600, check=True)
        ms = json.loads(proc.stdout.strip().splitlines()[-1])["ms"]
        got = torch.load(dump).float()
        first = got if first is None else first
        print(json.dumps({"tree": tree, "turn": i, "ms": ms, "shape": SHAPE,
                          "max_abs_diff_to_first": float((got - first).abs().max())}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
