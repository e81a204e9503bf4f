"""The soma-clustering model (paper §4.7.1) as the program runs it.

A frozen copy of ``chip_smoke.py``'s ``soma_model`` (lines 662-696 there):
two kinds, two substances (diffusion 4.0, decay 0.002) secreted by their
own kind and climbed by it, Eq 4.1 mechanics through the fused cell-list
kernel, the diffusion kernel, ``cell_rank`` in the grid build, and the
``exposure`` op.  The numbers come from ``soma-tissue.json``; the traffic's
``space_um`` sets the box side and, at the configuration's density, the
population.  Positions are uniform inside the margin and kinds are fair
coin flips, both drawn on the card from the seed.
"""

from __future__ import annotations

import dataclasses

import torch

# The program's kernels this configuration runs (built at set-up).
KERNELS = ("cell_rank", "cell_list_force", "diffusion3d")


def derived(cfg: dict, traffic: dict) -> dict:
    """The configuration at the traffic's size, as the reference reads it."""
    space = float(traffic["space_um"])
    return dict(cfg, space=space, agents=int(round(cfg["density_per_um3"] * space ** 3)),
                check_frequencies=[cfg["sort_frequency"]])


def starts(cfg: dict, traffic: dict, seed: int, device, count: int) -> list:
    """``count`` initial populations drawn from ``seed``: every one of the
    same size, at uniform positions and with random kinds."""
    full = derived(cfg, traffic)
    n, space, margin = full["agents"], full["space"], float(cfg["margin_um"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = []
    for _ in range(count):
        pos = torch.rand((n, 3), generator=gen, device=device) * (space - 2 * margin) + margin
        kind = (torch.rand((n,), generator=gen, device=device) < 0.5).to(torch.int32)
        out.append({"position": pos, "kind": kind})
    return out


def setup(cfg: dict, traffic: dict, starts: list, device) -> dict:
    """Nothing to derive from the starts."""
    return {}


def simulation(cfg: dict, traffic: dict, start: dict, seed: int, device):
    """The program's model on one start (a ``Simulation``, not built)."""
    from repro_torch import Simulation
    from repro_torch.core import ForceParams, chemotaxis, concentration_at, secretion

    full = derived(cfg, traffic)
    space = full["space"]
    s0, s1 = cfg["substances"]

    def exposure_op(ctx, state):
        """Integrate each agent's own-substance concentration."""
        pool = state.pool
        c0 = concentration_at(state.grids[s0], pool.position)
        c1 = concentration_at(state.grids[s1], pool.position)
        own = torch.where(pool.kind == 0, c0, c1)
        dose = torch.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    res = int(round(space / cfg["voxel_um"]))
    params = ForceParams(repulsion_k=cfg["repulsion_k"],
                         attraction_gamma=cfg["attraction_gamma"],
                         static_tolerance=cfg["static_tolerance"])
    return (
        Simulation(space=(0.0, space), cell_size=cfg["box_um"], boundary=cfg["boundary"],
                   dt=cfg["dt"], max_per_cell=cfg["max_per_cell"], seed=int(seed),
                   sort_frequency=cfg["sort_frequency"], rank_impl="cuda", device=device)
        .add_agents(full["agents"], position=start["position"], diameter=cfg["diameter_um"],
                    kind=start["kind"], exposure=0.0)
        .add_substance(s0, diffusion=cfg["diffusion"], decay=cfg["decay"], resolution=res)
        .add_substance(s1, diffusion=cfg["diffusion"], decay=cfg["decay"], resolution=res)
        .use(secretion(s0, cfg["secretion"], kind=0), secretion(s1, cfg["secretion"], kind=1),
             chemotaxis(s0, cfg["chemotaxis"], kind=0),
             chemotaxis(s1, cfg["chemotaxis"], kind=1))
        .mechanics(params, impl="fused", diffusion_impl="cuda")
        .op(exposure_op, name="exposure", phase="post")
    )


def prepare(built, start: dict):
    """The initial state of ``built`` for ``start`` (nothing beyond the build)."""
    return built.state


def start_mismatches(cfg: dict, start: dict, snap: dict) -> int:
    """Values of the program's initial state that are not the start's."""
    n = start["position"].shape[0]
    bad = int((snap["position"][:n] != start["position"].float()).any(-1).sum())
    bad += int((snap["kind"][:n] != start["kind"]).sum())
    bad += int((snap["diameter"][:n] != float(cfg["diameter_um"])).sum())
    bad += int((~snap["alive"][:n]).sum()) + int(snap["alive"][n:].sum())
    bad += int((snap["age"] != 0).sum()) + int((snap["attrs"]["exposure"] != 0).sum())
    bad += sum(int((f != 0).sum()) for f in snap["fields"].values())
    return bad
