"""The JAX side of the distributed-engine parity tests (tests/test_torch_distributed.py).

Run as a script in a subprocess with eight forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_reference.py OUT.npz [PORT_CHECKPOINT_DIR]

It runs the reference (``repro.core.distributed`` with ``force_impl=
"reference"`` and rank ``"xla"``, so no Pallas interpreter runs) on the
cases below and writes every result into one ``.npz``, keys joined by
``/``.  ``PORT_CHECKPOINT_DIR``, when given, is a killed distributed run of
the port, which the reference resumes.

The cases' inputs are made here with numpy from fixed seeds; the functions
that make them import no JAX, so the port's test builds the same inputs
from this module.
"""

import dataclasses
import os
import sys

import numpy as np

# ----------------------------------------------------------------- the cases

FORCE_STEPS = (1, 5)
FORCE_CODECS = ("int16", "int8")
DIFFUSE_STEPS = 3
SOMA_STEPS = 4
RESUME_STEPS, RESUME_EVERY, RESUME_KILL = 12, 3, 6
ELASTIC_STEPS, ELASTIC_EVERY = 4, 2


def force_setup():
    """tests/dist_scenarios.py's 4×2 force-only relaxation: the domain, the
    engine's numbers and the 500 starting positions."""
    extent = 16.0
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(4, 2), extent=extent,
                  halo_width=2.0, halo_capacity=96, migrate_capacity=48, depth=16.0)
    engine = dict(dt=0.05, min_bound=0.0, max_bound=extent, boundary="open",
                  sort_frequency=4)
    rng = np.random.default_rng(42)
    pos = rng.uniform(2.0, [4 * extent - 2.0, 2 * extent - 2.0, 14.0], (500, 3))
    return domain, engine, pos.astype(np.float32)


def diffuse_setup():
    """An uneven 2×2 split (33 voxels over 2 ranks a dim) of one field."""
    space, res = 32.0, 33
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=space / 2,
                  halo_width=2.0, halo_capacity=32, migrate_capacity=16, depth=space)
    rng = np.random.default_rng(5)
    field = rng.uniform(0.0, 1.0, (res, res, res)).astype(np.float32)
    pos = rng.uniform(4.0, space - 4.0, (8, 3)).astype(np.float32)
    return domain, space, res, field, pos


def soma_setup():
    """A small soma-clustering model (two substances on ramps, secretion,
    chemotaxis, an exposure op, a kind observable) on a 2×2 mesh."""
    space, res, n = 40.0, 10, 240
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=space / 2,
                  halo_width=4.0, halo_capacity=64, migrate_capacity=32, depth=space,
                  halo_codec="int16")
    rng = np.random.default_rng(17)
    pos = rng.uniform(2.0, space - 2.0, (n, 3)).astype(np.float32)
    kind = (rng.random(n) < 0.5).astype(np.int32)
    i, j, k = np.meshgrid(*[np.arange(res, dtype=np.float32)] * 3, indexing="ij")
    fields = ((2.0 + 0.6 * i + 0.4 * j + 0.2 * k).astype(np.float32),
              (2.0 + 0.1 * i + 0.3 * j + 0.2 * k).astype(np.float32))
    return domain, space, res, pos, kind, fields


def resume_setup():
    """tests/dist_scenarios.py's facade-resume model: 200 agents of two
    kinds on a 2×2 mesh."""
    space = 32.0
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=space / 2,
                  halo_width=2.0, halo_capacity=96, migrate_capacity=48, depth=space,
                  halo_codec="int16")
    rng = np.random.default_rng(11)
    pos = rng.uniform(1.0, space - 1.0, (200, 3)).astype(np.float32)
    kinds = rng.integers(0, 2, 200).astype(np.int32)
    return domain, space, pos, kinds


def elastic_setup():
    """tests/dist_scenarios.py's distributed regrowth: 48 dividing agents in
    per-rank pools of 32."""
    space = 32.0
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=space / 2,
                  halo_width=3.0, halo_capacity=64, migrate_capacity=32, depth=space,
                  halo_codec="none")
    rng = np.random.default_rng(5)
    pos = rng.uniform(3.0, space - 3.0, (48, 3)).astype(np.float32)
    return domain, space, pos


# ------------------------------------------------------------ npz layout

def flatten(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def unflatten(arrays, prefix):
    """The nested dict under ``prefix`` of a flattened mapping."""
    out = {}
    for key in arrays:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arrays[key]
    return out


# ------------------------------------------------------------ the JAX side

def _main(out_path, port_ckpt=None):
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax
    import jax.numpy as jnp

    from repro.core import EngineConfig, ForceParams, Simulation
    from repro.core import distributed as dist
    from repro.core.behaviors import cell_division, chemotaxis, secretion
    from repro.core.diffusion import concentration_at
    from repro.launch import elastic
    from repro.launch.mesh import make_mesh

    out = {}

    def to_np(state):
        pool = state.pool
        g = lambda x: np.asarray(jax.device_get(x))
        grids = {}
        for name, grid in state.grids.items():
            grids[name] = dict(concentration=g(grid.concentration), origin=grid.origin,
                               spacing=grid.spacing,
                               diffusion_coefficient=grid.diffusion_coefficient,
                               decay_constant=grid.decay_constant)
            if grid.n_valid is not None:
                grids[name].update(n_valid=g(grid.n_valid), frame_shift=g(grid.frame_shift))
        return dict(
            pool={**{f: g(getattr(pool, f)) for f in ("position", "diameter", "kind", "age",
                                                      "alive", "static", "overflow")},
                  "attrs": {k: g(v) for k, v in pool.attrs.items()}},
            grids=grids,
            codec={f.name: g(getattr(state.codec, f.name))
                   for f in dataclasses.fields(state.codec)},
            rng=g(state.rng), step=g(state.step),
            **{k: g(getattr(state, k)) for k in ("migrate_overflow", "halo_overflow",
                                                  "halo_payload_bytes",
                                                  "halo_baseline_bytes")},
            health={f.name: g(getattr(state.health, f.name))
                    for f in dataclasses.fields(state.health)},
            ghost={f.name: g(getattr(state.ghost, f.name))
                   for f in dataclasses.fields(state.ghost)},
        )

    def put(key, state):
        out.update(flatten(to_np(state), key + "/"))

    # 1. The force-only relaxation, int16 and int8, after 1 and 5 steps.
    domain, engine, pos = force_setup()
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"])
    for codec in FORCE_CODECS:
        dcfg = dist.DomainConfig(**domain, halo_codec=codec)
        ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                            force_params=ForceParams(), **engine)
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
        put(f"force/{codec}/0", state)
        step = dist.make_distributed_step(mesh, dcfg, ecfg)
        for i in range(1, max(FORCE_STEPS) + 1):
            state = step(state)
            if i in FORCE_STEPS:
                put(f"force/{codec}/{i}", state)

    # 2. distributed_diffuse on an uneven split, closed and toroidal.
    domain, space, res, field, dpos = diffuse_setup()
    dcfg = dist.DomainConfig(**domain)
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"])
    sim = (Simulation(space=(0.0, space), cell_size=2.0, boundary="closed", dt=0.05,
                      max_per_cell=32, capacity=16)
           .add_agents(position=dpos, diameter=1.6)
           .add_substance("s", diffusion=1.0, resolution=res, concentration=field))
    grids = sim._split_grids(dcfg)["s"]
    out["diffuse/n_valid"] = np.asarray(grids.n_valid)
    out["diffuse/frame_shift"] = np.asarray(grids.frame_shift)
    out["diffuse/0"] = np.asarray(grids.concentration)
    from jax.sharding import PartitionSpec as P
    for boundary in ("closed", "toroidal"):
        body = lambda g, b=boundary: jax.tree.map(
            lambda x: x[None],
            dist.distributed_diffuse(dcfg, jax.tree.map(lambda x: x[0], g), 0.05, b))
        run = jax.jit(dist.shard_map(body, mesh=mesh, in_specs=P(dcfg.mesh_axes),
                                     out_specs=P(dcfg.mesh_axes)))
        g = grids
        for _ in range(DIFFUSE_STEPS):
            g = run(g)
        out[f"diffuse/{boundary}"] = np.asarray(g.concentration)

    # 3. The soma model through Simulation.distribute.
    domain, space, res, spos, kind, fields = soma_setup()
    dcfg = dist.DomainConfig(**domain)
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"])

    def exposure_op(ctx, state):
        pool = state.pool
        c0 = concentration_at(state.grids["substance_0"], pool.position)
        c1 = concentration_at(state.grids["substance_1"], pool.position)
        own = jnp.where(pool.kind == 0, c0, c1)
        dose = jnp.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    soma = (Simulation(space=(0.0, space), cell_size=4.0, boundary="closed", dt=1.0,
                       max_per_cell=32, seed=4)
            .add_agents(position=spos, diameter=3.0, kind=kind, exposure=0.0)
            .add_substance("substance_0", diffusion=0.4, decay=0.002, resolution=res,
                           concentration=fields[0])
            .add_substance("substance_1", diffusion=0.4, decay=0.002, resolution=res,
                           concentration=fields[1])
            .use(secretion("substance_0", 1.0, kind=0), secretion("substance_1", 1.0, kind=1),
                 chemotaxis("substance_0", 0.75, kind=0),
                 chemotaxis("substance_1", 0.75, kind=1))
            .mechanics(ForceParams())
            .op(exposure_op, name="exposure", phase="post")
            .observe_kinds("kinds", n_kinds=2))
    dsim = soma.distribute(mesh, dcfg, capacity=128)
    put("soma/0", dsim.state)
    final, obs = dsim.run(SOMA_STEPS)
    put("soma/final", final)
    out["soma/obs/kinds"] = np.asarray(obs["kinds"])

    # 4. Cross-package resume: a killed reference run for the port to
    #    resume, and the port's killed run resumed here.
    domain, space, rpos, rkinds = resume_setup()
    dcfg = dist.DomainConfig(**domain)
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"])

    def resume_model():
        return (Simulation(space=(0.0, space), cell_size=2.0, boundary="open", dt=0.05,
                           max_per_cell=32, seed=3, sort_frequency=4, capacity=256)
                .add_agents(position=rpos, diameter=1.6, kind=rkinds)
                .mechanics(ForceParams())
                .observe_kinds("counts", n_kinds=2)).distribute(mesh, dcfg)

    straight, sobs = resume_model().run(RESUME_STEPS)
    put("resume/straight", straight)
    out["resume/straight_obs/counts"] = np.asarray(sobs["counts"])

    class Killed(Exception):
        pass

    def killer(state):
        if int(np.asarray(state.step).ravel()[0]) >= RESUME_KILL:
            raise Killed

    ckpt_dir = out_path + ".ckpt"
    try:
        resume_model().run(RESUME_STEPS, checkpoint_dir=ckpt_dir,
                           checkpoint_every=RESUME_EVERY, on_chunk=killer)
    except Killed:
        pass
    if port_ckpt:
        final, robs = resume_model().resume(port_ckpt)
        put("resume/of_port", final)
        out["resume/of_port_obs/counts"] = np.asarray(robs["counts"])

    # 5. run_elastic_distributed.
    domain, space, epos = elastic_setup()
    dcfg = dist.DomainConfig(**domain)
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"])
    grow = (Simulation(space=(0.0, space), cell_size=3.0, boundary="open", dt=1.0,
                       max_per_cell=32, seed=2, capacity=256)
            .add_agents(position=epos, diameter=2.0)
            .use(cell_division(0.5))
            .observe("pop", lambda s: s.pool.alive.sum().astype(jnp.int32)))
    final, eobs, grows = elastic.run_elastic_distributed(
        grow, mesh, dcfg, ELASTIC_STEPS, out_path + ".elastic", checkpoint_every=ELASTIC_EVERY,
        capacity=32, max_regrows=4)
    put("elastic/final", final)
    out["elastic/obs/pop"] = np.asarray(eobs["pop"])
    out["elastic/grows"] = np.asarray(grows)

    np.savez(out_path, **out)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
