"""The tumor spheroid of paper §4.6.2 (Algorithm 2), one step, in plain PyTorch.

Every step: the Morton layout sort, the grid of the step's start, then the
behaviours in order — Brownian motion (a unit normal direction times the
rate), volumetric growth up to the largest diameter, division (the mother
keeps half the volume, the daughter appears in a random direction at a
quarter of the mother's diameter, in the k-th free row for the k-th
division in row order), apoptosis after a least age — then Eq 4.1 contact
forces between the agents of the grid (a daughter joins the grid next
step; an agent that died this step still pushes its neighbours), the
closed boundary, the static flags, ageing, the telemetry, and every
``census_frequency`` steps the radial census.

The draws follow ``jax.random``: the step's key is ``fold_in(rng, step)``
and each random behaviour splits it in turn (``threefry.py``).
"""

from __future__ import annotations

import math

import torch

from abm_bench.reference import plain as p
from abm_bench.reference import threefry as tf


def step(cfg: dict, state: dict, dtype=torch.float32) -> dict:
    lo, hi = (float(x) for x in cfg["space"])
    box = float(cfg["box_um"])
    n = int((hi - lo) / box)
    dt = float(cfg["dt"])
    s = dict(state)
    s["position"] = state["position"].to(dtype)
    s["diameter"] = state["diameter"].to(dtype)
    s["age"] = state["age"].to(dtype)
    s["attrs"] = {k: v.to(dtype) for k, v in state["attrs"].items()}
    t = s["step"]

    key = tf.fold_in(s["rng"], t)
    s = p.layout_sort(s, lo, box, n)
    alive0 = s["alive"]
    grid = p.Grid(s["position"], alive0, lo, box, n, int(cfg["max_per_cell"]))
    pre = s["position"]
    c = pre.shape[0]

    # Brownian motion.
    key, k_move = tf.split(key)
    move = p.unit(tf.normal(k_move, (c, 3)).to(dtype)) * float(cfg["brownian_rate"])
    pos = s["position"] + torch.where(alive0[:, None], move, torch.zeros_like(move))

    # Growth.
    d = s["diameter"]
    grown = p.cube_root(6.0 * (p.ball_volume(d) + float(cfg["growth_rate"]) * dt) / math.pi)
    dmax = float(cfg["max_diameter"])
    d = torch.where(alive0 & (d < dmax), grown.clamp(max=dmax), d)

    # Division.
    key, k_div = tf.split(key)
    k_prob, k_dir = tf.split(k_div)
    u = tf.uniform(k_prob, (c,))
    divides = alive0 & (u < float(cfg["division_probability"])) & (
        d >= float(cfg["division_trigger_um"]))
    vol = p.ball_volume(d)
    d_half = p.cube_root(6.0 * vol * 0.5 / math.pi)
    direction = p.unit(tf.normal(k_dir, (c, 3)).to(dtype))
    child_pos = pos + direction * (0.5 * 0.5 * d)[:, None]
    d = torch.where(divides, d_half, d)
    free = torch.nonzero(~alive0).reshape(-1)
    parents = torch.nonzero(divides).reshape(-1)
    placed = min(free.numel(), parents.numel())
    rows, parents = free[:placed], parents[:placed]
    alive, kind, age = alive0.clone(), s["kind"].clone(), s["age"].clone()
    static = s["static"].clone()
    pos = pos.clone()
    pos[rows] = child_pos[parents]
    d = d.clone()
    d[rows] = d_half[parents]
    kind[rows] = s["kind"][parents]
    age[rows] = 0.0
    alive[rows] = True
    static[rows] = False
    attrs = {}
    for name, v in s["attrs"].items():
        v = v.clone()
        v[rows] = s["attrs"][name][parents]
        attrs[name] = v
    overflow = int(s["overflow"]) + max(int(divides.sum()) - free.numel(), 0)

    # Apoptosis.
    key, k_die = tf.split(key)
    u = tf.uniform(k_die, (c,))
    dies = alive & (age >= float(cfg["apoptosis_min_age_h"])) & (
        u < float(cfg["apoptosis_probability"]))
    alive = alive & ~dies

    # Contact forces between the agents of the step's grid.
    force = p.contact_forces(grid, pos, d * 0.5, float(cfg["repulsion_k"]),
                             float(cfg["attraction_gamma"]), dtype)
    pos = pos + torch.where(alive[:, None], force, torch.zeros_like(force)) * dt
    pos = pos.clamp(lo, hi)
    static = p.moved_static(grid, pre, pos, alive, float(cfg["static_tolerance"]), lo, box, n)
    age = age + torch.where(alive, torch.full_like(age, dt), torch.zeros_like(age))
    out = dict(s, position=pos, diameter=d, kind=kind, age=age, alive=alive, static=static,
               attrs=attrs, overflow=overflow)
    out["health"] = p.health(out, state["health"], grid.overflowed)
    if t % int(cfg["census_frequency"]) == 0:
        centre = (lo + hi) / 2.0
        r = torch.sqrt(((pos - centre) ** 2).sum(-1))
        out["attrs"] = dict(attrs, radial=torch.where(alive, r, torch.zeros_like(r)))
    out["step"] = t + 1
    return out


def observed(cfg: dict, state: dict) -> dict:
    """What a modeller reads after a step: the live cells."""
    return {"kind_counts": state["alive"].sum().reshape(1).to(torch.int64)}
