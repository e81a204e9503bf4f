"""The soma-clustering model of paper §4.7.1, one step, in plain PyTorch.

Two kinds of agents, each secreting its own substance and moving up that
substance's gradient; Eq 4.1 contact mechanics in a uniform grid; Eq 4.3
diffusion with decay; a closed boundary; each agent integrates the
concentration of its own substance (the ``exposure`` attribute).  The order
within a step is Algorithm 8's: the layout sort (every ``sort_frequency``
steps), the grid of the step's start, the behaviours (secretion of both
substances, then chemotaxis up both), the contact forces, the boundary, the
static flags, diffusion, ageing, the telemetry, then the exposure.

``step(cfg, state, dtype)`` works out the state after one step from the
state before it; ``cfg`` is ``configs/soma-tissue.json`` with the traffic's
``space_um`` under ``space``.
"""

from __future__ import annotations

import torch

from abm_bench.reference import plain as p


def step(cfg: dict, state: dict, dtype=torch.float32) -> dict:
    space, box = float(cfg["space"]), float(cfg["box_um"])
    n = int(space / box)
    dt = float(cfg["dt"])
    res = int(round(space / cfg["voxel_um"]))
    spacing = space / res
    s = dict(state)
    s["position"] = state["position"].to(dtype)
    s["diameter"] = state["diameter"].to(dtype)
    s["age"] = state["age"].to(dtype)
    s["attrs"] = {k: v.to(dtype) for k, v in state["attrs"].items()}
    s["fields"] = {k: v.to(dtype) for k, v in state["fields"].items()}

    if s["step"] % int(cfg["sort_frequency"]) == 0:
        s = p.layout_sort(s, 0.0, box, n)
    alive, kind = s["alive"], s["kind"]
    grid = p.Grid(s["position"], alive, 0.0, box, n, int(cfg["max_per_cell"]))
    pre = s["position"]

    fields = dict(s["fields"])
    subs = cfg["substances"]
    for k, name in enumerate(subs):
        fields[name] = p.secrete(fields[name], s["position"], alive & (kind == k),
                                 float(cfg["secretion"]), 0.0, spacing)
    pos = s["position"]
    for k, name in enumerate(subs):
        g = p.gradient_unit(fields[name], pos, 0.0, spacing)
        mask = (alive & (kind == k))[:, None]
        pos = pos + torch.where(mask, g * float(cfg["chemotaxis"]), torch.zeros_like(g))

    radius = s["diameter"] * 0.5
    force = p.contact_forces(grid, pos, radius, float(cfg["repulsion_k"]),
                             float(cfg["attraction_gamma"]), dtype)
    pos = pos + torch.where(alive[:, None], force, torch.zeros_like(force)) * dt
    pos = pos.clamp(0.0, space)
    static = p.moved_static(grid, pre, pos, alive, float(cfg["static_tolerance"]),
                            0.0, box, n)
    for name in subs:
        fields[name] = p.diffuse(fields[name], float(cfg["diffusion"]), float(cfg["decay"]),
                                 dt, spacing)
    age = s["age"] + torch.where(alive, torch.full_like(s["age"], dt), torch.zeros_like(s["age"]))
    out = dict(s, position=pos, static=static, age=age, fields=fields)
    out["health"] = p.health(out, state["health"], grid.overflowed)

    own = torch.where(kind == 0, p.value_at(fields[subs[0]], pos, 0.0, spacing),
                      p.value_at(fields[subs[1]], pos, 0.0, spacing))
    exposure = s["attrs"]["exposure"]
    out["attrs"] = dict(s["attrs"], exposure=exposure + torch.where(alive, own * dt,
                                                                    torch.zeros_like(own)))
    out["step"] = s["step"] + 1
    return out


def observed(cfg: dict, state: dict) -> dict:
    """What a modeller reads after a step: the live agents of each kind."""
    kinds = torch.arange(int(cfg["kinds"]), device=state["kind"].device)
    counts = ((state["kind"][:, None] == kinds) & state["alive"][:, None]).sum(0)
    return {"kind_counts": counts.to(torch.int64)}
