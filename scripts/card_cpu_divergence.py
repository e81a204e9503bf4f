#!/usr/bin/env python3
"""How far the soma model's card run drifts from its CPU run, step by step.

    python3 scripts/card_cpu_divergence.py        # on a machine with a card

The card and the CPU differ in the last bits of a step: the kernels sum the
pair forces in other orders than their plain versions, and the card's own
arithmetic and reductions differ from the CPU's for the same plain PyTorch
ops.  Where agents touch, the contact mechanics amplify such a difference
from step to step.  For the soma model of
``chip_smoke.py`` (ramp fields, every kernel switched on) this prints the
largest position difference after each of 8 steps, in two witnesses:

1. solo runs on the card against solo runs on the CPU, at the ``small``
   phase's size and density (120 agents, 10^3 boxes), at 2,000 agents at
   path 1's density (0.6 a box, 15^3 boxes) and at the ``small`` density
   (26^3 boxes), each with the mechanics on and off;
2. at path 1's density on seeds 0, 1 and 2: the card's kernels against the
   card running their plain versions (the CPU's sum orders on the card),
   and that run against the CPU: which of the two sources the drift
   comes from.

``chip_smoke.py``'s ``batch_small`` takes its gated density from this.
"""

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = (("small", 120, 100.0, 20), ("path1_density", 2000, 150.0, 30),
         ("small_density", 2000, 260.0, 52))
SEEDS = (0, 1, 2)


def main() -> int:
    if not torch.cuda.is_available():
        print("card_cpu_divergence: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.set_num_threads(1)

    def positions(n, space, res, dev, mechanics, seed=0):
        sim = cs.soma_model(n, space, res, seed, dev, concentration=cs.ramp_fields(res))
        if not mechanics:
            sim.mechanics(None, impl="fused", diffusion_impl="cuda")
        _, obs = sim.observe("pos", lambda s: s.pool.position).build().run(8)
        return obs["pos"].cpu()

    def by_step(a, b):
        return (a - b).abs().amax(dim=(1, 2)).tolist()

    for name, n, space, res in CASES:
        for mechanics in (True, False):
            err = by_step(positions(n, space, res, "cuda", mechanics),
                          positions(n, space, res, "cpu", mechanics))
            print(json.dumps({"witness": "card_vs_cpu", "case": name, "agents": n,
                              "space_um": space, "mechanics": mechanics,
                              "max_position_err_by_step": err}), flush=True)
    _, n, space, res = CASES[1]
    for seed in SEEDS:
        kernels = positions(n, space, res, "cuda", True, seed)
        with cs.plain_versions_on_card():
            plain = positions(n, space, res, "cuda", True, seed)
        cpu = positions(n, space, res, "cpu", True, seed)
        print(json.dumps({"witness": "kernels_vs_plain_on_card", "case": CASES[1][0],
                          "agents": n, "space_um": space, "seed": seed,
                          "kernels_vs_card_plain_by_step": by_step(kernels, plain),
                          "card_plain_vs_cpu_by_step": by_step(plain, cpu),
                          "kernels_vs_cpu_by_step": by_step(kernels, cpu)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
