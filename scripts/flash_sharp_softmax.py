#!/usr/bin/env python3
"""How far each flash-attention version lies from the exact result when the
softmax is sharp, on one NVIDIA GPU.

    python3 scripts/flash_sharp_softmax.py [--card-cases]

q, k, v from a CPU generator (seeds 104, 7, 9 and 11), rounded to bf16, at
whisper's cross-attention shape (B 1 and 4, 8 heads, 448 queries over
1,500 keys, D 64, no mask), at the card tests' causal case (B 2, 6 / 2
heads, T 200, D 128) and at paligemma-3b's prefill call (B 4, 8 / 1 heads,
T 2,304, D 256, causal with a prefix of 256: the D 256 tensor-core kernel);
q scaled by 1, 4 and 8.  Against a float64 softmax attention on the CPU,
for the tensor-core kernel, the SIMT kernel and the plain version (on the
card, f32 products without TF32) in f32 and on the bf16 inputs: the
outputs beyond one bf16 ulp + 1e-6 of the exact value (``2**-7 |exact| +
1e-6``, the card tests' bound), the largest error and the largest excess
over the bound.  One JSON line a case, then the card's name and power
limit.

With ``--card-cases``: the D 256 cases of the card test
``test_flash_attention_tensor_cores_ragged_and_sharp`` at q x8, each on its
own seed and on seeds 200-215, built as the test builds them; for each
version the count beyond the bound, the largest excess over
``2**-7 |exact|`` and whether every output is finite.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CASES = (   # ((B, Hq, Hkv, Tq, Tk, D), mask kwargs, seed)
    ((1, 8, 8, 448, 1500, 64), dict(causal=False), 104),
    ((1, 8, 8, 448, 1500, 64), dict(causal=False), 7),
    ((4, 8, 8, 448, 1500, 64), dict(causal=False), 9),
    ((2, 6, 2, 200, 200, 128), dict(causal=True), 100),
    ((4, 8, 1, 2304, 2304, 256), dict(causal=True, prefix_len=256), 11),
)


def exact(q, k, v, causal, prefix_len=0):
    """Softmax attention in float64 on the CPU."""
    from repro_torch.kernels.flash_attention.ref import visible

    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    kr, vr = (t.double().repeat_interleave(q.shape[1] // k.shape[1], 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) * d ** -0.5
    mask = visible(torch.arange(tq)[:, None], torch.arange(tk)[None, :], causal, None,
                   prefix_len)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s.masked_fill(~mask, -torch.inf), -1),
                        vr)


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


def card_cases() -> None:
    """The card test's D 256 sharp cases over more seeds (``--card-cases``)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from test_torch_cuda import FLASH_TC_CASES, _exact_attention

    for case in sorted(FLASH_TC_CASES):
        seed0, (b, hq, hkv, tq, tk, d), kw = FLASH_TC_CASES[case]
        if d != 256:
            continue
        for seed in [seed0, *range(200, 216)]:
            g = torch.Generator().manual_seed(seed)
            q, k, v = (torch.randn(s, generator=g)
                       for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
            q, k, v = (q * 8.0).bfloat16(), k.bfloat16(), v.bfloat16()
            want = _exact_attention(q, k, v, **kw).numpy()
            qc, kc, vc = (t.transpose(1, 2).contiguous().transpose(1, 2).cuda()
                          for t in (q, k, v))
            got = {
                "tensor_cores": fa_k.flash_attention_wgmma_cuda(qc, kc, vc, **kw),
                "simt": fa_k.flash_attention_simt_cuda(qc, kc, vc, **kw),
                "plain_f32": fa_ops.chunked_attention(q.float().cuda(), k.float().cuda(),
                                                      v.float().cuda(), block_k=64, **kw),
            }
            out = {}
            for name, r in got.items():
                x = r.float().cpu().numpy()
                excess = np.abs(x - want) - 2.0 ** -7 * np.abs(want)
                out[name] = {"beyond_bound": int((excess > 1e-6).sum()),
                             "max_excess": float(excess.max()),
                             "finite": bool(np.isfinite(x).all())}
            print(json.dumps({"case": case, "seed": seed, "outputs": want.size, **out}),
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sharp_softmax: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--card-cases" in sys.argv[1:]:
        card_cases()
        print_card()
        return 0
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops

    for (b, hq, hkv, tq, tk, d), kw, seed in CASES:
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g)
                   for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
        for q_scale in (1.0, 4.0, 8.0):
            qb, kb, vb = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
            want = exact(qb, kb, vb, **kw)
            # The model's layout: (B, T, H, D) storage seen as (B, H, T, D).
            qc, kc, vc = (t.transpose(1, 2).contiguous().transpose(1, 2).cuda()
                          for t in (qb, kb, vb))
            got = {
                "tensor_cores": fa_k.flash_attention_wgmma_cuda(qc, kc, vc, **kw),
                "simt": fa_k.flash_attention_simt_cuda(qc, kc, vc, **kw),
                "plain_f32": fa_ops.chunked_attention(qc.float(), kc.float(), vc.float(),
                                                      block_k=64, **kw),
                "plain_bf16": fa_ops.chunked_attention(qc, kc, vc, block_k=64, **kw),
            }
            out = {}
            for name, r in got.items():
                err = (r.double().cpu() - want).abs()
                over = err - (2.0 ** -7 * want.abs() + 1e-6)
                out[name] = {"beyond_bound": int((over > 0).sum()), "max_err": float(err.max()),
                             "max_over_bound": float(over.max())}
            print(json.dumps({"shape": [b, hq, hkv, tq, tk, d], "mask": kw, "seed": seed,
                              "q_scale": q_scale, "outputs": want.numel(), **out}), flush=True)
    print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
