"""The four use-case models of ``examples/`` declared through the port.

Each builder mirrors its example's model (same parameters, same custom ops,
rewritten in torch) and takes ``device=``; the ``*_main`` functions apply
the examples' own science bars.  This module imports no JAX, so the card
tests can use it.  ``neurite_extension`` draws through
``repro_torch.core.prng`` and spawns with ``add_agents``, and the SIR model
draws its initial positions with ``prng.uniform`` from the same key as the
reference, so both packages start from the same population.
"""

import dataclasses

import numpy as np
import torch

from repro_torch import Simulation
from repro_torch.core import (
    INFECTED,
    RECOVERED,
    SUSCEPTIBLE,
    ForceParams,
    Operation,
    add_agents,
    apoptosis,
    brownian_motion,
    cell_division,
    chemotaxis,
    concentration_at,
    gradient_at,
    growth,
    prng,
    random_movement,
    secretion,
    sir_infection,
    sir_recovery,
)
from repro_torch.core.grid import build_index, candidate_neighbors

# ------------------------------------------------------------ tumor spheroid
# examples/tumor_spheroid.py (paper §4.6.2, Fig 4.16, Algorithm 2).


def radial_census_op(center: float, frequency: int = 8) -> Operation:
    """Distance-from-seed census every ``frequency`` steps ("mask" gate)."""

    def fn(ctx, state):
        pool = state.pool
        r = torch.linalg.vector_norm(pool.position - center, dim=-1)
        return dataclasses.replace(
            state, pool=pool.set_attr("radial", torch.where(pool.alive, r, 0.0)))

    return Operation("radial_census", fn, phase="post", frequency=frequency, gate="mask")


def spheroid(position, diameter=14.0, *, space=300.0, capacity=4096, seed=0,
             device="cpu", impl="fused", tile_order="linear", morton_window=None,
             sort_frequency=16, rank_impl="tiled"):
    """The spheroid model: Table 4.2 rates, 18 µm boxes, ``max_per_cell=96``,
    dt = 1 h, closed boundary, the radial census at the space's centre.
    ``space``: the extent ``[0, space]`` or ``(min, max)``."""
    position = np.asarray(position, np.float32)
    lo, hi = (0.0, float(space)) if np.ndim(space) == 0 else map(float, space)
    return (
        Simulation(space=(lo, hi), cell_size=18.0, boundary="closed", dt=1.0,
                   capacity=capacity, max_per_cell=96, seed=seed,
                   sort_frequency=sort_frequency, rank_impl=rank_impl, device=device)
        .add_agents(len(position), position=position, diameter=diameter, radial=0.0)
        .use(brownian_motion(0.15), growth(60.0, 18.0),
             cell_division(0.02, trigger_diameter=17.0), apoptosis(0.002, min_age=87.0))
        .mechanics(ForceParams(), impl=impl, tile_order=tile_order,
                   morton_window=morton_window)
        .op(radial_census_op((lo + hi) / 2.0))
    )


def spheroid_start(n, space, seed=0, lattice=12.0):
    """A grown spheroid: the ``n`` sites of a ``lattice``-µm cubic lattice
    nearest the centre of ``space`` (as in :func:`spheroid`), jittered by
    U(−1, 1) µm; diameters U[14, 18), ages U[20, 220) h.  Returns numpy
    ``(position, diameter, age)``."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil((2 * n) ** (1 / 3))) + 2
    g = (np.arange(side) - (side - 1) / 2.0) * lattice
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    order = np.argsort(np.linalg.norm(sites, axis=1), kind="stable")[:n]
    center = space / 2.0 if np.ndim(space) == 0 else (space[0] + space[1]) / 2.0
    pos = sites[order] + center + rng.uniform(-1.0, 1.0, (n, 3))
    diam = rng.uniform(14.0, 18.0, n)
    age = rng.uniform(20.0, 220.0, n)
    return pos.astype(np.float32), diam.astype(np.float32), age.astype(np.float32)


def spheroid_diameter(pool) -> float:
    alive = pool.alive.cpu().numpy()
    pos = pool.position.cpu().numpy()[alive]
    if len(pos) < 2:
        return 0.0
    center = pos.mean(axis=0)
    return float(2.0 * np.quantile(np.linalg.norm(pos - center, axis=1), 0.95))


def spheroid_main(n_init=60, capacity=4096, steps=240, seed=0):
    """``examples/tumor_spheroid.py``'s ``main()`` on the port (CPU), with
    its bars: population > 1.5×, diameter > 1.2×, roughly monotone."""
    rng = np.random.default_rng(seed)
    pos = (150.0 + rng.normal(0, 12.0, (n_init, 3))).astype(np.float32)
    built = spheroid(pos, space=300.0, capacity=capacity, seed=seed).build()
    state = built.state
    d0, n0 = spheroid_diameter(state.pool), int(state.pool.num_alive())
    diam = []
    for _ in range(6):
        state, _ = built.run(steps // 6, state=state)
        diam.append(spheroid_diameter(state.pool))
    n1 = int(state.pool.num_alive())
    radial = state.pool.get("radial")[state.pool.alive]
    assert float(radial.max()) > 0.0, "radial census op did not fire"
    assert n1 > 1.5 * n0, "population did not grow"
    assert diam[-1] > d0 * 1.2, "spheroid did not expand"
    assert diam[-1] >= max(diam[:3]) * 0.9
    return n0, n1, d0, diam


# --------------------------------------------------------------- SIR (Fig 4.17)
# examples/epidemiology_sir.py (paper §4.6.3).

BETA, GAMMA = 0.06719, 0.00521          # per hour: R0 = 12.9, recovery 8 days


def infectious_time_op(ctx, state):
    """Accumulate each agent's time spent infected."""
    pool = state.pool
    dt = torch.where(pool.alive & (pool.kind == INFECTED), ctx.config.dt, 0.0)
    return dataclasses.replace(state, pool=pool.set_attr("t_inf", pool.get("t_inf") + dt))


def analytical_sir(n, i0, beta, gamma, steps):
    """RK4 integration of the Kermack–McKendrick ODEs (hourly steps)."""
    y = np.array([n - i0, i0, 0.0], np.float64)

    def f(y):
        s, i, _ = y
        inf = beta * s * i / n
        return np.array([-inf, inf - gamma * i, gamma * i])

    out = [y.copy()]
    for _ in range(steps):
        k1 = f(y)
        k2 = f(y + 0.5 * k1)
        k3 = f(y + 0.5 * k2)
        k4 = f(y + k3)
        y = y + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
        out.append(y.copy())
    return np.stack(out)


def sir(params, n, i0, space, seed=0, device="cpu"):
    """The agent-based SIR model: random movement, infection, recovery on a
    toroidal space, S/I/R counts observed every step."""
    radius, prob, move = (float(p) for p in params)
    pos = prng.uniform(prng.PRNGKey(seed), (n, 3), 0.0, space)
    kind = torch.where(torch.arange(n) < i0, INFECTED, SUSCEPTIBLE).to(torch.int32)
    return (
        Simulation(space=(0.0, space), cell_size=max(radius, 4.0), boundary="toroidal",
                   dt=1.0, max_per_cell=128, seed=seed, device=device)
        .add_agents(n, position=pos, diameter=0.5, kind=kind, t_inf=0.0)
        .use(random_movement(move), sir_infection(radius, prob), sir_recovery(GAMMA))
        .op(infectious_time_op, name="infectious_time", phase="post")
        .observe_kinds("counts", n_kinds=3)
    )


def sir_fast_rmse(seed=0):
    """``examples/epidemiology_sir.py --fast`` on the port: 400 agents, 300
    steps, the calibrated fast-mode parameters; trajectory RMSE against the
    analytical solution as a fraction of the population."""
    n, i0, space, steps = 400, 8, 55.0, 300
    truth = analytical_sir(n, i0, BETA, GAMMA, steps)[1:]
    final, obs = sir((3.24, 0.36, 6.2), n, i0, space, seed).run(steps)
    counts = obs["counts"].numpy()
    t_inf = final.pool.get("t_inf").numpy()
    assert (final.pool.kind.numpy() == RECOVERED).any() and t_inf.max() > 0
    return float(np.sqrt(np.mean(((counts - truth) / n) ** 2)))


# ------------------------------------------------------------- neurite growth
# examples/neurite_growth.py (paper §4.6.1, Fig 4.13, Algorithm 1).

TRAIL, CONE = 0, 1


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def path_length_op(ctx, state):
    """Arc length grown by each cone this step (cones alive at env build)."""
    pool = state.pool
    seg = torch.linalg.vector_norm(pool.position - ctx.pre_positions, dim=-1)
    grew = pool.alive & ctx.neighbors.query_alive & (pool.kind == CONE)
    return dataclasses.replace(
        state, pool=pool.set_attr("path_len",
                                  pool.get("path_len") + torch.where(grew, seg, 0.0)))


def neurite_extension(grid_name, speed, w_old, w_grad, w_rand, branch_prob,
                      target_z=1e9):
    """Algorithm 1 as a behaviour: move cones, deposit trail, bifurcate;
    cones retire to trail on reaching ``target_z``."""

    def run(ctx, pool):
        ctx, key = ctx.next_rng()
        k_dir, k_branch = prng.split(key)
        reached = pool.alive & (pool.kind == CONE) & (pool.position[:, 2] >= target_z)
        pool = pool.replace(kind=torch.where(reached, TRAIL, pool.kind))
        cones = pool.alive & (pool.kind == CONE)

        grad = gradient_at(ctx.grids[grid_name], pool.position, normalized=True)
        prev = pool.get("direction")
        rand = _unit(prng.normal(k_dir, pool.position.shape))
        direction = _unit(w_old * prev + w_grad * grad + w_rand * rand)

        cap = pool.capacity
        pool = add_agents(pool, spawn_mask=cones, position=pool.position,
                          diameter=pool.diameter * 0.8,
                          kind=torch.full((cap,), TRAIL, dtype=torch.int32,
                                          device=pool.device))
        new_pos = pool.position + direction * speed
        pool = pool.replace(position=torch.where(cones[:, None], new_pos, pool.position))
        pool = pool.set_attr("direction", torch.where(cones[:, None], direction, prev))

        u = prng.uniform(k_branch, (cap,))
        branch = cones & (u < branch_prob)
        # Filled on the device: a host tensor copied in would fail a CUDA
        # graph's capture under run_jit.
        x_axis = torch.zeros_like(direction)
        x_axis[:, 0] = 1.0
        side = _unit(torch.linalg.cross(direction, x_axis, dim=-1))
        pool = add_agents(pool, spawn_mask=branch,
                          position=pool.position + side * 1.2 * pool.diameter[:, None],
                          diameter=pool.diameter,
                          kind=torch.full((cap,), CONE, dtype=torch.int32,
                                          device=pool.device),
                          attrs={"direction": side})
        return ctx, pool

    return run


def neurite(n_neurons, space=120.0, seed=0, device="cpu", *, plate=None, cue_top=None,
            capacity=8192, active_capacity=2048, impl="reference", rank_impl="tiled"):
    """The neurite model: cones on the bottom plate under a static cue that
    rises with z, §5.5 work compaction, the path-length op.

    ``plate``: the ``(lo, hi)`` range of x and y the somata are drawn over
    (default: 20 µm in from the walls).  ``cue_top``: the height where the
    cue peaks (default: the top of the space); the cue lies on 5 µm voxels,
    so it is the same function of z at any ``space``.  ``active_capacity``
    ``None`` evaluates every agent each step (no compaction)."""
    rng = np.random.default_rng(seed)
    lo, hi = (20.0, space - 20.0) if plate is None else map(float, plate)
    xy = rng.uniform(lo, hi, (n_neurons, 2))
    pos = np.concatenate([xy, np.full((n_neurons, 1), 10.0)], axis=1).astype(np.float32)
    res = int(round(space / 5.0))
    top = space if cue_top is None else float(cue_top)
    zs = (np.arange(res) + 0.5) * (space / res)
    conc = np.exp(-((zs - top) ** 2) / (2 * 40.0**2))
    cue = np.broadcast_to(conc[None, None, :], (res, res, res)).astype(np.float32)
    return (
        Simulation(space=(0.0, space), cell_size=4.0, boundary="closed", dt=0.5,
                   capacity=capacity, max_per_cell=128, seed=seed, diffusion_frequency=0,
                   rank_impl=rank_impl, device=device)
        .add_agents(n_neurons, position=pos, diameter=2.0,
                    kind=np.full((n_neurons,), CONE, np.int32),
                    direction=np.tile(np.array([[0.0, 0.0, 1.0]], np.float32),
                                      (n_neurons, 1)),
                    path_len=0.0)
        .add_substance("guide", diffusion=0.0, resolution=res, concentration=cue)
        .use(neurite_extension("guide", speed=2.4, w_old=4.0, w_grad=1.5, w_rand=0.6,
                               branch_prob=0.02, target_z=104.0))
        .mechanics(ForceParams(static_tolerance=1e-3), impl=impl,
                   active_capacity=active_capacity)
        .op(path_length_op, name="path_length", phase="post")
    )


def neurite_bars(pool, n_neurons):
    """``examples/neurite_growth.py``'s science bars on a final pool, per
    neuron → ``(alive, static fraction)``."""
    alive_mask = pool.alive.cpu()
    alive = int(alive_mask.sum())
    kinds = pool.kind.cpu()[alive_mask].numpy()
    n_trail = int((kinds == TRAIL).sum())
    static_frac = float(pool.static.cpu().sum()) / max(alive, 1)
    z = pool.position.cpu()[alive_mask][:, 2].numpy()
    path = pool.get("path_len").cpu()[alive_mask].numpy()
    assert path.max() > 60.0, "path-length op did not accumulate along growth"
    assert n_trail > n_neurons * 30, "trail not deposited"
    assert alive > n_neurons * 45, "no bifurcations happened"
    assert z.max() > 60.0, "growth did not follow the chemical cue"
    assert static_frac > 0.6, "arbor did not become static (§5.5 regime)"
    return alive, static_frac


def neurite_main(n_neurons=8, steps=100, seed=0, jit=False, **model):
    """``examples/neurite_growth.py``'s ``main()`` on the port, with its bars:
    four chunks of ``run`` (or of ``run_jit``, as the example steps)."""
    built = neurite(n_neurons, seed=seed, **model).build()
    run = built.run_jit if jit else built.run
    state = built.state
    for _ in range(4):
        state, _ = run(steps // 4, state=state)
    return neurite_bars(state.pool, n_neurons)


# ------------------------------------------------------ soma clustering (quickstart)
# examples/quickstart.py (paper §4.7.1, Fig 4.18).


def soma(n_cells, space, seed=0, device="cpu"):
    """Two kinds, each secreting its own substance and chemotaxing up it."""

    def exposure_op(ctx, state):
        pool = state.pool
        c0 = concentration_at(state.grids["substance_0"], pool.position)
        c1 = concentration_at(state.grids["substance_1"], pool.position)
        own = torch.where(pool.kind == 0, c0, c1)
        dose = torch.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    rng = np.random.default_rng(seed)
    pos = rng.uniform(10, space - 10, (n_cells, 3)).astype(np.float32)
    kind = (rng.random(n_cells) < 0.5).astype(np.int32)
    return (
        Simulation(space=(0.0, space), cell_size=10.0, boundary="closed", dt=1.0,
                   max_per_cell=64, seed=seed, device=device)
        .add_agents(n_cells, position=pos, diameter=5.0, kind=kind, exposure=0.0)
        .add_substance("substance_0", diffusion=4.0, decay=0.002, resolution=20)
        .add_substance("substance_1", diffusion=4.0, decay=0.002, resolution=20)
        .use(secretion("substance_0", 1.0, kind=0), secretion("substance_1", 1.0, kind=1),
             chemotaxis("substance_0", 0.75, kind=0),
             chemotaxis("substance_1", 0.75, kind=1))
        .mechanics(ForceParams())
        .op(exposure_op, name="exposure", phase="post")
    )


def same_type_fraction(spec, pool) -> float:
    """Fraction of neighbour pairs within 10 µm that share a kind."""
    index = build_index(spec, pool)
    cand, mask = candidate_neighbors(spec, index, pool)
    safe = torch.where(mask, cand, 0).long()
    d2 = ((pool.position[:, None, :] - pool.position[safe]) ** 2).sum(dim=-1)
    close = mask & (d2 < 10.0**2)
    same = close & (pool.kind[safe] == pool.kind[:, None])
    return float(same.sum()) / max(int(close.sum()), 1)


def soma_main(n_cells=400, steps=200, space=90.0, seed=0):
    """``examples/quickstart.py``'s ``main()`` on the port."""
    built = soma(n_cells, space, seed).build()
    before = same_type_fraction(built.config.spec, built.state.pool)
    final, _ = built.run(steps)
    after = same_type_fraction(built.config.spec, final.pool)
    exposure = final.pool.get("exposure")[final.pool.alive]
    assert bool(exposure.ne(0).any()), "exposure op never fired"
    assert bool(torch.isfinite(final.pool.position[final.pool.alive]).all())
    return before, after
