"""Carry a simulation state, LM parameters, or an LM train state across as
numpy.

The layout is a nested dict of numpy arrays and python numbers — the
leaves of the reference's ``SimulationState``:

    {"pool":   {"position", "diameter", "kind", "age", "alive", "static",
                "overflow", "attrs": {name: array}},
     "grids":  {name: {"concentration", "origin", "spacing",
                       "diffusion_coefficient", "decay_constant"}},
     "rng":    (2,) uint32 raw key data,
     "step":   int,
     "health": {field: int}}

:func:`state_from_numpy` builds the port's state from it and
:func:`state_to_numpy` goes the other way, so that two engines can start
from one state and be compared leaf by leaf.

:func:`dist_state_from_numpy` / :func:`dist_state_to_numpy` do the same for
the distributed engine's stacked ``DistState``: every array carries the
leading rank axis, a grid may add ``n_valid`` / ``frame_shift``, and

    {"codec":  {"send_ref", "recv_ref", "prev_ids", "scale"},
     "ghost":  {"position", "radius", "kind", "alive"},
     "migrate_overflow", "halo_overflow", "halo_payload_bytes",
     "halo_baseline_bytes": (R,) int32}

join the single-node leaves (``rng`` (R, 2), ``step`` (R,), ``health``
fields (R,)).

:func:`lm_params_from_numpy` / :func:`lm_params_to_numpy` carry the LM
stack's parameter trees (nested dicts, the reference's keys), and
:func:`train_state_from_numpy` / :func:`train_state_to_numpy` a whole train
state: ``params``, ``opt`` (``step``, ``mu``, ``nu``) and ``step``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.agents import AgentPool
from .core.diffusion import DiffusionGrid
from .core.distributed import DistState, GhostFrame, HaloCodecState
from .core.engine import SimulationState
from .core.schedule import HEALTH_FIELDS, HealthReport

POOL_FIELDS = ("position", "diameter", "kind", "age", "alive", "static", "overflow")
GRID_META = ("origin", "spacing", "diffusion_coefficient", "decay_constant")

_DTYPES = {
    "position": torch.float32, "diameter": torch.float32, "kind": torch.int32,
    "age": torch.float32, "alive": torch.bool, "static": torch.bool,
    "overflow": torch.int32,
}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def state_from_numpy(arrays: Dict[str, Any], device: torch.device | str) -> SimulationState:
    """The port's :class:`SimulationState` on ``device`` from numpy leaves."""
    p = arrays["pool"]
    pool = AgentPool(
        **{f: _tensor(p[f], device, _DTYPES[f]) for f in POOL_FIELDS},
        attrs={k: _tensor(v, device) for k, v in p["attrs"].items()},
    )
    grids = {
        name: DiffusionGrid(
            concentration=_tensor(g["concentration"], device, torch.float32),
            origin=tuple(float(x) for x in g["origin"]),
            spacing=float(g["spacing"]),
            diffusion_coefficient=float(g["diffusion_coefficient"]),
            decay_constant=float(g["decay_constant"]),
        )
        for name, g in arrays["grids"].items()
    }
    rng = np.asarray(arrays["rng"], dtype=np.uint32).reshape(2)
    health = HealthReport(**{
        f: torch.tensor(int(arrays["health"][f]), dtype=torch.int32, device=device)
        for f in HEALTH_FIELDS
    })
    return SimulationState(
        pool=pool,
        grids=grids,
        rng=_tensor(rng, device),
        step=torch.tensor(int(arrays["step"]), dtype=torch.int32, device=device),
        health=health,
    )


def state_to_numpy(state: SimulationState) -> Dict[str, Any]:
    """The numpy leaves of a port state (the layout above)."""
    np_ = lambda t: t.detach().cpu().numpy()
    pool = state.pool
    return {
        "pool": {
            **{f: np_(getattr(pool, f)) for f in POOL_FIELDS},
            "attrs": {k: np_(v) for k, v in pool.attrs.items()},
        },
        "grids": {
            name: {"concentration": np_(g.concentration),
                   **{m: getattr(g, m) for m in GRID_META}}
            for name, g in state.grids.items()
        },
        "rng": np_(state.rng).astype(np.uint32),
        "step": int(state.step),
        "health": {f: int(getattr(state.health, f)) for f in HEALTH_FIELDS},
    }


# -------------------------------------------------------- distributed state

DIST_COUNTERS = ("migrate_overflow", "halo_overflow", "halo_payload_bytes",
                 "halo_baseline_bytes")
CODEC_FIELDS = ("send_ref", "recv_ref", "prev_ids", "scale")
GHOST_FIELDS = ("position", "radius", "kind", "alive")
_GHOST_DTYPES = {"position": torch.float32, "radius": torch.float32, "kind": torch.int32,
                 "alive": torch.bool}


def _grid_from_numpy(g: Dict[str, Any], device) -> DiffusionGrid:
    pad = {k: _tensor(g[k], device, dt) for k, dt in
           (("n_valid", torch.int32), ("frame_shift", torch.float32))
           if g.get(k) is not None}
    return DiffusionGrid(
        concentration=_tensor(g["concentration"], device, torch.float32),
        origin=tuple(float(x) for x in np.asarray(g["origin"]).reshape(-1)),
        spacing=float(g["spacing"]),
        diffusion_coefficient=float(g["diffusion_coefficient"]),
        decay_constant=float(g["decay_constant"]),
        **pad,
    )


def dist_state_from_numpy(arrays: Dict[str, Any], device: torch.device | str) -> DistState:
    """The port's stacked :class:`DistState` on ``device`` from numpy leaves
    (the layout above)."""
    p = arrays["pool"]
    pool = AgentPool(
        **{f: _tensor(p[f], device, _DTYPES[f]) for f in POOL_FIELDS},
        attrs={k: _tensor(v, device) for k, v in p.get("attrs", {}).items()},
    )
    c = arrays["codec"]
    return DistState(
        pool=pool,
        grids={name: _grid_from_numpy(g, device)
               for name, g in arrays.get("grids", {}).items()},
        codec=HaloCodecState(
            send_ref=_tensor(c["send_ref"], device, torch.float32),
            recv_ref=_tensor(c["recv_ref"], device, torch.float32),
            prev_ids=_tensor(c["prev_ids"], device, torch.int32),
            scale=_tensor(c["scale"], device, torch.float32),
        ),
        rng=_tensor(np.asarray(arrays["rng"], dtype=np.uint32), device),
        step=_tensor(arrays["step"], device, torch.int32),
        **{k: _tensor(arrays[k], device, torch.int32) for k in DIST_COUNTERS},
        health=HealthReport(**{f: _tensor(arrays["health"][f], device, torch.int32)
                               for f in HEALTH_FIELDS}),
        ghost=GhostFrame(**{f: _tensor(arrays["ghost"][f], device, _GHOST_DTYPES[f])
                            for f in GHOST_FIELDS}),
    )


def dist_state_to_numpy(state: DistState) -> Dict[str, Any]:
    """The numpy leaves of a port ``DistState`` (the layout above)."""
    np_ = lambda t: t.detach().cpu().numpy()
    pool = state.pool
    grids = {}
    for name, g in state.grids.items():
        grids[name] = {"concentration": np_(g.concentration),
                       **{m: getattr(g, m) for m in GRID_META}}
        for k in ("n_valid", "frame_shift"):
            if getattr(g, k) is not None:
                grids[name][k] = np_(getattr(g, k))
    return {
        "pool": {
            **{f: np_(getattr(pool, f)) for f in POOL_FIELDS},
            "attrs": {k: np_(v) for k, v in pool.attrs.items()},
        },
        "grids": grids,
        "codec": {f: np_(getattr(state.codec, f)) for f in CODEC_FIELDS},
        "rng": np_(state.rng).astype(np.uint32),
        "step": np_(state.step),
        **{k: np_(getattr(state, k)) for k in DIST_COUNTERS},
        "health": {f: np_(getattr(state.health, f)) for f in HEALTH_FIELDS},
        "ghost": {f: np_(getattr(state.ghost, f)) for f in GHOST_FIELDS},
    }


# ------------------------------------------------------------ LM parameters

def lm_params_from_numpy(tree: Dict[str, Any], device: torch.device | str,
                         dtype: torch.dtype | None = None) -> Dict[str, Any]:
    """The port's LM parameter tree from the reference's value tree
    (``unzip(model.init(key))[0]``) as nested dicts of numpy arrays: the same
    keys, each array copied to ``device`` (and cast to ``dtype`` if given)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device, dtype)


def lm_params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's LM parameter tree as nested dicts of numpy arrays (bf16
    values widened to f32, which numpy has)."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ------------------------------------------------------------ train state

def train_state_from_numpy(state, device: torch.device | str):
    """The port's ``TrainState`` on ``device`` from the reference's (or any
    object with its fields: ``params``, ``opt.step``, ``opt.mu``,
    ``opt.nu``, ``step``) with numpy leaves; the steps as int32."""
    from .optim.adamw import AdamWState
    from .training import TrainState

    return TrainState(
        params=lm_params_from_numpy(state.params, device),
        opt=AdamWState(step=_tensor(np.asarray(state.opt.step), device, torch.int32),
                       mu=lm_params_from_numpy(state.opt.mu, device),
                       nu=lm_params_from_numpy(state.opt.nu, device)),
        step=_tensor(np.asarray(state.step), device, torch.int32),
    )


def train_state_to_numpy(state):
    """A port ``TrainState`` with numpy leaves, the reference's fields and
    order (``jax.tree.leaves`` of the two give the same arrays)."""
    from .optim.adamw import AdamWState
    from .training import TrainState

    step = lambda t: t.detach().cpu().numpy()
    return TrainState(
        params=lm_params_to_numpy(state.params),
        opt=AdamWState(step=step(state.opt.step), mu=lm_params_to_numpy(state.opt.mu),
                       nu=lm_params_to_numpy(state.opt.nu)),
        step=step(state.step),
    )
