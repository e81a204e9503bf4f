#!/usr/bin/env python3
"""How far each flash-attention version lies from the exact result when the
softmax is sharp, on one NVIDIA GPU.

    python3 scripts/flash_sharp_softmax.py

q, k, v from a CPU generator (seeds 104, 7 and 9), rounded to bf16, at
whisper's cross-attention shape (B 1 and 4, 8 heads, 448 queries over
1,500 keys, D 64, no mask) and at the card tests' causal case (B 2, 6 / 2
heads, T 200, D 128); q scaled by 1, 4 and 8.  Against a float64 softmax
attention on the CPU, for the tensor-core kernel, the SIMT kernel and the
plain version in f32 and on the bf16 inputs: the outputs beyond one bf16
ulp + 1e-6 of the exact value (``2**-7 |exact| + 1e-6``, the card tests'
bound), the largest error and the largest excess over the bound.  One JSON
line a case, then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CASES = (   # ((B, Hq, Hkv, Tq, Tk, D), causal, seed)
    ((1, 8, 8, 448, 1500, 64), False, 104),
    ((1, 8, 8, 448, 1500, 64), False, 7),
    ((4, 8, 8, 448, 1500, 64), False, 9),
    ((2, 6, 2, 200, 200, 128), True, 100),
)


def exact(q, k, v, causal):
    """Softmax attention in float64 on the CPU."""
    from repro_torch.kernels.flash_attention.ref import visible

    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    kr, vr = (t.double().repeat_interleave(q.shape[1] // k.shape[1], 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) * d ** -0.5
    mask = visible(torch.arange(tq)[:, None], torch.arange(tk)[None, :], causal, None, 0)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s.masked_fill(~mask, -torch.inf), -1),
                        vr)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sharp_softmax: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops

    for (b, hq, hkv, tq, tk, d), causal, seed in CASES:
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g)
                   for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
        for q_scale in (1.0, 4.0, 8.0):
            qb, kb, vb = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
            want = exact(qb, kb, vb, causal)
            # The model's layout: (B, T, H, D) storage seen as (B, H, T, D).
            qc, kc, vc = (t.transpose(1, 2).contiguous().transpose(1, 2).cuda()
                          for t in (qb, kb, vb))
            got = {
                "tensor_cores": fa_k.flash_attention_wgmma_cuda(qc, kc, vc, causal=causal),
                "simt": fa_k.flash_attention_simt_cuda(qc, kc, vc, causal=causal),
                "plain_f32": fa_ops.chunked_attention(qb.float(), kb.float(), vb.float(),
                                                      causal=causal, block_k=64),
                "plain_bf16": fa_ops.chunked_attention(qb, kb, vb, causal=causal, block_k=64),
            }
            out = {}
            for name, r in got.items():
                err = (r.double().cpu() - want).abs()
                over = err - (2.0 ** -7 * want.abs() + 1e-6)
                out[name] = {"beyond_bound": int((over > 0).sum()), "max_err": float(err.max()),
                             "max_over_bound": float(over.max())}
            print(json.dumps({"shape": [b, hq, hkv, tq, tk, d], "causal": causal, "seed": seed,
                              "q_scale": q_scale, "outputs": want.numel(), **out}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
