"""The reference's ``hlo_overlap_report`` on the overlapped-schedule layout
of tests/test_torch_dist_lanes.py (tests/dist_scenarios.py's overlap
parity: 300 agents and blobs on the rank faces and corner of a 2×2 mesh).

Run as a script in a subprocess with four forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_overlap_reference.py OUT.json

It compiles the reference's distributed step (``force_impl="reference"``,
rank ``"xla"``: no Pallas interpreter) for each model of :data:`MODELS`
under the serial and the overlapped schedule, and writes each compiled
module's ``hlo_overlap_report`` into OUT.json, keyed ``model/schedule``.
The inputs and the models' numbers are made here with numpy and plain
Python; the functions the port's test reads import no JAX.
"""

import json
import sys

import numpy as np

MODELS = ("forces", "neighbour_behaviour")
SCHEDULES = ("serial", "overlap")
CROWDED = 3             # candidates beyond which an agent shrinks
SHRINK = 0.999


def overlap_setup():
    """The domain, the engine's numbers and the starting positions."""
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=16.0, halo_width=2.0,
                  halo_capacity=96, migrate_capacity=48, depth=32.0, halo_codec="int16")
    engine = dict(dt=0.05, min_bound=0.0, max_bound=32.0, boundary="open", sort_frequency=4)
    rng = np.random.default_rng(21)
    pos = rng.uniform(1.0, 31.0, (300, 3))
    blobs = [rng.uniform([15.0, 1.0, 4.0], [17.0, 31.0, 12.0], (40, 3)),
             rng.uniform([1.0, 15.0, 4.0], [31.0, 17.0, 12.0], (40, 3)),
             rng.uniform([15.2, 15.2, 4.0], [16.8, 16.8, 12.0], (20, 3))]
    return domain, engine, np.concatenate([pos] + blobs).astype(np.float32)


def shrink_crowded(ctx, pool, where):
    """The neighbour-reading behaviour, written once for both packages:
    an agent with more than CROWDED live candidates shrinks by SHRINK
    (``where``: ``jnp.where`` or ``torch.where``)."""
    crowded = ctx.cand_mask.sum(1) > CROWDED
    return ctx, pool.replace(diameter=where(crowded, pool.diameter * SHRINK, pool.diameter))


def main(out_path):
    import dataclasses

    import jax.numpy as jnp

    from repro.core import EngineConfig, ForceParams
    from repro.core import distributed as dist
    from repro.launch.mesh import make_mesh

    domain, engine, pos = overlap_setup()
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"])
    behaviours = {"forces": (),
                  "neighbour_behaviour": (lambda c, p: shrink_crowded(c, p, jnp.where),)}
    out = {}
    for model in MODELS:
        for schedule in SCHEDULES:
            dcfg = dist.DomainConfig(**domain, overlap_halo=schedule == "overlap")
            spec = dataclasses.replace(dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                                       rank_impl="xla")
            ecfg = EngineConfig(spec=spec, force_params=ForceParams(), force_impl="reference",
                                behaviors=behaviours[model], **engine)
            state = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6)
            step = dist.make_distributed_step(mesh, dcfg, ecfg)
            text = step.lower(state).compile().as_text()
            out[f"{model}/{schedule}"] = dist.hlo_overlap_report(text)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
