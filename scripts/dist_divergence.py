#!/usr/bin/env python3
"""How far the distributed soma model parts from the single-node one.

Run from the root of a checkout:

    python3 scripts/dist_divergence.py [--space 200] [--steps 3] [--device cpu|cuda]

Builds ``chip_smoke.py``'s soma model at path 1's density (0.6 agents a 10 um
box, 5 um voxels) in a cube of ``--space`` um, once single-node and once
through ``Simulation.distribute`` on the 2 x 2 mesh of ``chip_smoke.py``'s
``distributed`` phase (halo 10 um), with the halo codec ``"none"`` and
``"int16"``.  After each step it prints, for each codec, the largest
``gid``-matched distance to the single-node run over all agents and over
those 20 um or more from every rank face, and the number of agents more
than 1e-3 um away.  It also prints the int16 codec's coordinate range,
``extent + 2 * halo``, beside the depth of the non-decomposed dim, and the
largest z of rank 1's ghosts after one exchange against the largest z of the
agents that rank 0 sent it.  One JSON line a step and codec.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--space", type=float, default=200.0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import distributed as dist

    space = args.space
    n = int(0.6 * (space / 10.0) ** 3)
    cs.N_AGENTS, cs.SPACE, cs.RESOLUTION = n, space, int(space / 5.0)
    cs.DIST_CAPACITY = int(1.2 * n / 4) + 100
    cs.DIST_HALO_CAPACITY = cs.DIST_MIGRATE_CAPACITY = max(256, n // 4)

    built = cs.dist_soma_model(args.device).build()
    runs = {codec: cs.dist_soma(codec=codec, device=args.device) for codec in ("none", "int16")}

    d16 = runs["int16"]
    ranks = d16.step.unstack(d16.state)
    out, _ = dist.halo_exchange(d16.dcfg, d16.mesh, [r.pool for r in ranks],
                                [r.codec for r in ranks])
    ghosts_z = out[1][0][ranks[1].pool.position.shape[0]:, 2][out[1][3][ranks[1].pool.position.shape[0]:]]
    print(json.dumps({"agents": n, "space": space, "device": args.device,
                      "int16_range": d16.dcfg.extent + 2 * d16.dcfg.halo_width,
                      "depth": d16.dcfg.depth,
                      "rank1_ghost_z_max": float(ghosts_z.max()),
                      "agent_z_max": float(ranks[0].pool.position[ranks[0].pool.alive, 2].max())}),
          flush=True)

    single = built.state
    states = {codec: r.state for codec, r in runs.items()}
    for step in range(1, args.steps + 1):
        single, _ = built.run(1, state=single)
        _, sp = cs.gid_positions(single)
        for codec, dsim in runs.items():
            states[codec], _ = dsim.run(1, state=states[codec])
            _, dp = cs.gid_positions(states[codec], dsim.dcfg)
            far = cs.gid_distance(dp, sp, dsim.dcfg.n_decomposed, dsim.dcfg.extent)
            d = dp - sp
            d[:, :2] -= space * np.round(d[:, :2] / space)
            print(json.dumps({"step": step, "codec": codec, "max_distance": far,
                              "agents_beyond_1e-3": int((np.linalg.norm(d, axis=1) > 1e-3).sum())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main())
