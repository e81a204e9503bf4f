"""The tumor spheroid (paper §4.6.2, Algorithm 2) as the program runs it.

A frozen copy of ``chip_smoke.py``'s ``spheroid_model`` and
``spheroid_start`` (lines 803-846 there) and of ``spheroid_setup``'s window
(lines 957-973): Brownian motion, growth, division and apoptosis at the
Table 4.2 rates, Eq 4.1 mechanics through the Morton-window kernel at the
covering half-window plus a margin, 18 µm boxes, ``max_per_cell`` 96, the
layout sort every step and the mask-gated radial census.  A start is a grown
spheroid: the lattice sites nearest the centre, jittered, with diameters and
ages drawn from the seed on the card.
"""

from __future__ import annotations

import dataclasses

import torch

# The program's kernels this configuration runs (built at set-up).
KERNELS = ("cell_rank", "cell_window_force", "cell_list_force")


def derived(cfg: dict, traffic: dict) -> dict:
    """The configuration as the reference reads it; the check includes a
    step at which the census fires."""
    return dict(cfg, check_frequencies=[cfg["census_frequency"]])


def starts(cfg: dict, traffic: dict, seed: int, device, count: int) -> list:
    n, lattice = int(cfg["cells"]), float(cfg["lattice_um"])
    lo, hi = (float(x) for x in cfg["space"])
    side = int(-(-((2 * n) ** (1.0 / 3.0)) // 1)) + 2
    g = (torch.arange(side, dtype=torch.float64, device=device) - (side - 1) / 2.0) * lattice
    sites = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    order = torch.sort(torch.linalg.vector_norm(sites, dim=1), stable=True).indices[:n]
    sites = sites[order] + (lo + hi) / 2.0
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    jit = float(cfg["jitter_um"])
    (d0, d1), (a0, a1) = cfg["start_diameter_um"], cfg["start_age_h"]
    out = []
    for _ in range(count):
        shake = torch.rand((n, 3), generator=gen, device=device, dtype=torch.float64)
        pos = (sites + (2 * shake - 1) * jit).to(torch.float32)
        diam = torch.rand((n,), generator=gen, device=device) * (d1 - d0) + d0
        age = torch.rand((n,), generator=gen, device=device) * (a1 - a0) + a0
        out.append({"position": pos, "diameter": diam, "age": age})
    return out


def setup(cfg: dict, traffic: dict, starts: list, device) -> dict:
    """The Morton window: the half-window (blocks of ``morton_block`` rows)
    that covers every start once it is Morton-sorted, plus the margin,
    capped at all blocks."""
    from repro_torch.core.forces import covering_half_window
    from repro_torch.core.grid import build_index, sort_agents

    block, cap = int(cfg["morton_block"]), int(cfg["capacity"])
    cover = 0
    for start in starts:
        built = _simulation(cfg, start, 0, device, impl="fused").build()
        spec = built.config.spec
        pool = sort_agents(spec, built.state.pool)
        cover = max(cover, covering_half_window(
            spec, build_index(spec, pool, assume_sorted=True), block))
    margin = max(1, int(-(-cover * float(cfg["window_margin"]) // 1)))
    return {"half_window": min(cover + margin, cap // block)}


def _simulation(cfg, start, seed, device, **mechanics):
    from repro_torch import Simulation
    from repro_torch.core import (ForceParams, Operation, apoptosis, brownian_motion,
                                  cell_division, growth)

    lo, hi = (float(x) for x in cfg["space"])
    centre = (lo + hi) / 2.0

    def census(ctx, state):
        pool = state.pool
        r = torch.linalg.vector_norm(pool.position - centre, dim=-1)
        return dataclasses.replace(
            state, pool=pool.set_attr("radial", torch.where(pool.alive, r, 0.0)))

    params = ForceParams(repulsion_k=cfg["repulsion_k"],
                         attraction_gamma=cfg["attraction_gamma"],
                         static_tolerance=cfg["static_tolerance"])
    return (
        Simulation(space=(lo, hi), cell_size=cfg["box_um"], boundary=cfg["boundary"],
                   dt=cfg["dt"], capacity=int(cfg["capacity"]),
                   max_per_cell=cfg["max_per_cell"], seed=int(seed),
                   sort_frequency=cfg["sort_frequency"], rank_impl="cuda", device=device)
        .add_agents(int(cfg["cells"]), position=start["position"],
                    diameter=start["diameter"], radial=0.0)
        .use(brownian_motion(cfg["brownian_rate"]),
             growth(cfg["growth_rate"], cfg["max_diameter"]),
             cell_division(cfg["division_probability"],
                           trigger_diameter=cfg["division_trigger_um"]),
             apoptosis(cfg["apoptosis_probability"], min_age=cfg["apoptosis_min_age_h"]))
        .mechanics(params, **mechanics)
        .op(Operation("radial_census", census, phase="post",
                      frequency=int(cfg["census_frequency"]), gate="mask"))
    )


def simulation(cfg: dict, traffic: dict, start: dict, seed: int, device, half_window: int):
    return _simulation(cfg, start, seed, device, impl="fused", tile_order="morton",
                       morton_block=int(cfg["morton_block"]), morton_window=half_window)


def prepare(built, start: dict):
    """The built initial state with the start's ages."""
    pool = built.state.pool
    age = torch.zeros_like(pool.age)
    age[: start["age"].shape[0]] = start["age"]
    return dataclasses.replace(built.state, pool=pool.replace(age=age))


def start_mismatches(cfg: dict, start: dict, snap: dict) -> int:
    n = start["position"].shape[0]
    bad = int((snap["position"][:n] != start["position"]).any(-1).sum())
    bad += int((snap["diameter"][:n] != start["diameter"]).sum())
    bad += int((snap["age"][:n] != start["age"]).sum()) + int((snap["age"][n:] != 0).sum())
    bad += int((~snap["alive"][:n]).sum()) + int(snap["alive"][n:].sum())
    bad += int((snap["kind"] != 0).sum()) + int((snap["attrs"]["radial"] != 0).sum())
    return bad
