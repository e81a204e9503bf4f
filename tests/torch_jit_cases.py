"""Models for the compiled run's tests, declared through the port's facade
(``tests/test_torch_run_jit.py`` on the CPU, the ``run_jit`` card tests of
``tests/test_torch_cuda.py``).  This module imports no JAX.

Each model can be made to flip one branch predicate of the force pass
mid-run, deterministically, with a custom op that acts from a given step on
(it reads ``state.step`` on the device, so it needs no host read):

* :func:`crowd_op` stacks the first rows of the pool at one point, so one
  cell holds more than ``max_per_cell`` agents (``overflowed``; with a
  Morton window also its coverage gate, which refuses an overflowed index);
* :func:`kick_op` puts two rows in adjacent boxes on either side of the
  grid's top Z-order seam, so their rows lie a pool apart after the next
  sort and the Morton window stops covering them;
* :func:`nudge_op` moves the first rows a little every step, so they are
  active next step (``crowded`` past ``active_capacity``);
* :func:`negative_id_op` gives the index a negative cell id;
* :func:`crowd_gid_op` stacks the agents whose ``gid`` attribute is below
  k at one point: in a distributed model whose first k agents start in rank
  0's box (:func:`dist_crowd`), only rank 0's cell overflows.

:func:`dist_soma` and :func:`dist_crowd` deploy models on a 2x2 mesh of
ranks on one device for the distributed engine's compiled run
(``tests/test_torch_dist_jit.py``, the card tests).
"""

import dataclasses

import numpy as np
import torch

from repro_torch import Simulation
from repro_torch.checkpoint.checkpoint import _leaves_with_paths
from repro_torch.core import (ForceParams, apoptosis, brownian_motion, cell_division,
                              chemotaxis, concentration_at, growth, secretion)


def crowd_op(rows: int, at_step: int, point: float):
    """Rows ``[0, rows)`` moved to ``(point, point, point)`` on every step
    from ``at_step`` on."""

    def crowd(ctx, state):
        pos = state.pool.position
        head = torch.where(state.step >= at_step, point, pos[:rows])
        return dataclasses.replace(
            state, pool=state.pool.replace(position=torch.cat([head, pos[rows:]])))

    return crowd


def kick_op(at_step: int, p, q):
    """Rows 0 and 1 moved to ``p`` and ``q`` on every step from ``at_step``
    on."""
    pq = torch.tensor([p, q], dtype=torch.float32)
    on = {}     # pq on each device, copied there once (not inside a capture)

    def kick(ctx, state):
        pos = state.pool.position
        if pos.device not in on:
            on[pos.device] = pq.to(pos.device)
        head = torch.where(state.step >= at_step, on[pos.device], pos[:2])
        return dataclasses.replace(
            state, pool=state.pool.replace(position=torch.cat([head, pos[2:]])))

    return kick


def nudge_op(rows: int, at_step: int, dx: float):
    """Rows ``[0, rows)`` moved by ``dx`` along x on every step from
    ``at_step`` on (an agent-phase op: the static-flag pass sees the move)."""

    def nudge(ctx, state):
        pos = state.pool.position
        head = pos[:rows] + torch.where(state.step >= at_step, dx, 0.0)
        head = torch.cat([head[:, :1], pos[:rows, 1:]], dim=1)
        return dataclasses.replace(
            state, pool=state.pool.replace(position=torch.cat([head, pos[rows:]])))

    return nudge


def crowd_gid_op(k: int, at_step: int, point: float):
    """The live agents whose ``gid`` is below ``k`` moved to ``(point,
    point, point)`` (rank-local in a distributed model) on every step from
    ``at_step`` on."""

    def crowd(ctx, state):
        pool = state.pool
        hit = (pool.get("gid") < k) & pool.alive & (state.step >= at_step)
        pos = torch.where(hit[:, None], point, pool.position)
        return dataclasses.replace(state, pool=pool.replace(position=pos))

    return crowd


def negative_id_op(at_step: int):
    """From ``at_step`` on, cell ids of the step's index shifted below 0."""

    def corrupt(ctx, state):
        cid = ctx.index.cell_of_agent
        ctx.index = dataclasses.replace(
            ctx.index, cell_of_agent=torch.where(state.step >= at_step, cid - 100000, cid))
        return state

    return corrupt


def ramp_fields(res: int):
    i, j, k = np.meshgrid(*[np.arange(res, dtype=np.float32)] * 3, indexing="ij")
    return ((2.0 + 0.6 * i + 0.4 * j + 0.2 * k).astype(np.float32),
            (2.0 + 0.1 * i + 0.3 * j + 0.2 * k).astype(np.float32))


def soma(device, n=120, space=100.0, res=20, seed=0, **sim_kw):
    """The quickstart soma model with every agent kernel of the slice on
    (tests/test_torch_engine.py's), its position / fields / exposure
    series and kind counts every 3 steps."""

    def exposure_op(ctx, state):
        pool = state.pool
        c0 = concentration_at(state.grids["substance_0"], pool.position)
        c1 = concentration_at(state.grids["substance_1"], pool.position)
        own = torch.where(pool.kind == 0, c0, c1)
        dose = torch.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    rng = np.random.default_rng(seed)
    pos = rng.uniform(10, space - 10, (n, 3)).astype(np.float32)
    kind = (rng.random(n) < 0.5).astype(np.int32)
    c0, c1 = ramp_fields(res)
    return (
        Simulation(space=(0.0, space), cell_size=10.0, boundary="closed", dt=1.0,
                   max_per_cell=64, seed=seed, rank_impl="cuda", device=device, **sim_kw)
        .add_agents(n, position=pos, diameter=5.0, kind=kind, exposure=0.0)
        .add_substance("substance_0", diffusion=4.0, decay=0.002, resolution=res,
                       concentration=c0)
        .add_substance("substance_1", diffusion=4.0, decay=0.002, resolution=res,
                       concentration=c1)
        .use(secretion("substance_0", 1.0, kind=0), secretion("substance_1", 1.0, kind=1),
             chemotaxis("substance_0", 0.75, kind=0), chemotaxis("substance_1", 0.75, kind=1))
        .mechanics(ForceParams(), impl="fused", diffusion_impl="cuda")
        .op(exposure_op, name="exposure", phase="post")
        .observe("position", lambda s: s.pool.position)
        .observe("exposure", lambda s: s.pool.get("exposure"))
        .observe_kinds(frequency=3)
    )


def spheroid_start(n, space, lattice=20.0, seed=0):
    """``n`` lattice sites nearest the centre of ``space`` (a ``(lo, hi)``),
    jittered by U(-1, 1); diameters U[14, 18), ages U[20, 220)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil((2 * n) ** (1 / 3))) + 2
    g = (np.arange(side) - (side - 1) / 2.0) * lattice
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    order = np.argsort(np.linalg.norm(sites, axis=1), kind="stable")[:n]
    pos = sites[order] + (space[0] + space[1]) / 2.0 + rng.uniform(-1.0, 1.0, (n, 3))
    return (pos.astype(np.float32), rng.uniform(14.0, 18.0, n).astype(np.float32),
            rng.uniform(20.0, 220.0, n).astype(np.float32))


def spheroid(device, n=2000, capacity=4096, space=(-200.0, 200.0), crowd_at=None,
             **mechanics):
    """The tumour spheroid (Brownian motion, growth, division, apoptosis,
    Eq 4.1 mechanics, 18 um boxes, 96 a box, sorted every step) from a 20 um
    lattice; ``crowd_at``: 97 rows stacked at the centre from that step on."""
    pos, diam, age = spheroid_start(n, space)
    sim = (
        Simulation(space=space, cell_size=18.0, boundary="closed", dt=1.0,
                   capacity=capacity, max_per_cell=96, seed=0, sort_frequency=1,
                   rank_impl="cuda", device=device)
        .add_agents(n, position=pos, diameter=diam)
        .use(brownian_motion(0.15), growth(60.0, 18.0),
             cell_division(0.02, trigger_diameter=17.0), apoptosis(0.002, min_age=87.0))
        .mechanics(ForceParams(), **mechanics)
        .observe_kinds(n_kinds=1)
    )
    if crowd_at is not None:
        sim.op(crowd_op(97, crowd_at, (space[0] + space[1]) / 2.0), name="crowd",
               phase="agent")
    built = sim.build()
    ages = torch.zeros_like(built.state.pool.age)
    ages[:n] = torch.from_numpy(age).to(ages.device)
    return built, dataclasses.replace(built.state, pool=built.state.pool.replace(age=ages))


def leaf_bytes(final) -> dict:
    """``{checkpoint key: bytes}`` of a state's leaves."""
    return {k: (v.dtype, tuple(v.shape), v.detach().cpu().numpy().tobytes())
            for k, v in _leaves_with_paths(final)}


def assert_runs_bit_equal(a, b):
    """Two ``(final, outs)`` results equal bit for bit: every state leaf and
    every observable row."""
    (fa, oa), (fb, ob) = a, b
    la, lb = leaf_bytes(fa), leaf_bytes(fb)
    assert list(la) == list(lb)
    for k in la:
        assert la[k] == lb[k], f"state leaf {k} differs"
    if torch.is_tensor(oa):
        oa, ob = {"": oa}, {"": ob}
    assert set(oa) == set(ob)
    for name in oa:
        x, y = oa[name], ob[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.detach().cpu().numpy().tobytes() == y.detach().cpu().numpy().tobytes(), \
            f"observable {name!r} differs"


def dist_soma(device, n=4000, space=200.0, res=40, codec="int16", overlap=False):
    """:func:`soma` deployed on a 2x2 mesh of ranks on ``device`` (halo 10,
    the interaction radius)."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    dcfg = dist.DomainConfig(mesh_axes=("x", "y"), axis_sizes=(2, 2), extent=space / 2,
                             halo_width=10.0, halo_capacity=1024, migrate_capacity=512,
                             depth=space, halo_codec=codec, overlap_halo=overlap)
    return soma(device, n=n, space=space, res=res).distribute(
        make_mesh((2, 2), ("x", "y"), devices=device), dcfg)


def dist_crowd(device, k=12, at_step=4, impl="fused", mesh=None):
    """The reference's facade-resume layout (200 agents of two kinds in a
    32 um cube on a 2x2 mesh, boxes of 2 um holding 8) with ``gid``s, the
    first ``k`` agents placed inside rank 0's box and stacked at its centre
    from ``at_step`` on by :func:`crowd_gid_op`: rank 0's ``overflowed``
    predicate flips, the other ranks' do not.  ``mesh``: a process mesh to
    deploy on (default: an in-process mesh on ``device``)."""
    import torch_dist_reference as R
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    domain, space, pos, kinds = R.resume_setup()
    rng = np.random.default_rng(2)
    head = rng.uniform([4.0, 4.0, 8.0], [12.0, 12.0, 24.0], (k, 3)).astype(np.float32)
    pos = np.concatenate([head, pos[k:]])
    sim = (Simulation(space=(0.0, space), cell_size=2.0, boundary="open", dt=0.05,
                      max_per_cell=8, seed=3, sort_frequency=4, capacity=256,
                      rank_impl="cuda", device=device)
           .add_agents(position=pos, diameter=1.6, kind=kinds,
                       gid=np.arange(pos.shape[0], dtype=np.int32))
           .mechanics(ForceParams(), impl=impl)
           .op(crowd_gid_op(k, at_step, 8.0), name="crowd", phase="agent")
           .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32)))
    mesh = mesh or make_mesh(domain["axis_sizes"], domain["mesh_axes"], devices=device)
    return sim.distribute(mesh, dist.DomainConfig(**domain))
