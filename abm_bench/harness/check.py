"""How ``correct`` is decided: the program's steps against the plain reference.

The timed path's answers are whole simulation states, and a contact
simulation in f32 is chaotic: two correct implementations part after a few
dozen steps.  So the check follows the program step by step from its own
state.  A sampled answer of the window (an interval's or a job's final
state) is replayed from its input through the same entry, one step a call
(``run_jit(1)``), and the replay's end must equal the window's answer bit for
bit (``chain_off``).  At sampled steps of that replay the reference works out
the step from the program's input state, and the numbers below compare the
program's output with the reference's:

* ``rows_off``: the share of agent rows that disagree: alive or kind
  differ, or, on a live row, the position by more than ``POS_TOL`` µm, the
  diameter, age or a float attribute by more than ``REL_TOL`` of its size,
  or the static flag.
* ``pos_gap_um``: the largest position gap of a row live on both sides.
* ``field_gap``: the largest field gap over the largest field value.
* ``count_off``: integer values that differ: the step counter, the key, the
  overflow and health counters and the observed kind counts.
* ``chain_off``: leaves of the replay's end that differ from the window's
  answer; ``start_off``: values of the program's initial state that are not
  the inputs the benchmark made.

The limits live in ``checks/<workload>.json``.  ``PERF.md`` gives the
readings each was set from.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

POS_TOL = 1e-3
REL_TOL = 1e-5


def snapshot(state) -> dict:
    """The reference's view of a program state (solo): plain tensors, cloned."""
    pool = state.pool
    c = lambda t: t.detach().clone()
    return {
        "position": c(pool.position), "diameter": c(pool.diameter), "kind": c(pool.kind),
        "age": c(pool.age), "alive": c(pool.alive), "static": c(pool.static),
        "attrs": {k: c(v) for k, v in pool.attrs.items()},
        "overflow": int(pool.overflow),
        "fields": {k: c(g.concentration) for k, g in state.grids.items()},
        "rng": state.rng.to(torch.int64) & 0xFFFFFFFF,
        "step": int(state.step),
        "health": {f.name: int(getattr(state.health, f.name))
                   for f in dataclasses.fields(state.health)},
    }


def leaves_differ(a, b) -> int:
    """Tensor leaves of two program states whose bytes differ."""
    from repro_torch.checkpoint.checkpoint import _leaves_with_paths

    la, lb = _leaves_with_paths(a), _leaves_with_paths(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return max(len(la), len(lb))
    bad = 0
    for (_, x), (_, y) in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            bad += 1
        elif x.numel() and not torch.equal(x.reshape(-1).view(torch.uint8),
                                           y.reshape(-1).view(torch.uint8)):
            bad += 1
    return bad


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    return (a - b).abs() / b.abs().clamp(min=1.0)


def compare(got: dict, want: dict, got_obs: dict, want_obs: dict) -> dict:
    """The numbers of one checked step: ``got`` the program's (or the
    control's) state after it, ``want`` the reference's."""
    alive_g, alive_w = got["alive"], want["alive"]
    both = alive_g & alive_w
    gap = (got["position"].double() - want["position"].double()).abs().amax(-1)
    gap = torch.where(both, gap, torch.zeros_like(gap))
    off = (alive_g != alive_w) | (got["kind"] != want["kind"])
    row = (gap > POS_TOL) | (_rel(got["diameter"], want["diameter"]) > REL_TOL)
    row |= _rel(got["age"], want["age"]) > REL_TOL
    row |= got["static"] != want["static"]
    for name, v in want["attrs"].items():
        row |= _rel(got["attrs"][name], v) > REL_TOL
    off |= both & row
    field_gap = None
    for name, f in want["fields"].items():
        g = (got["fields"][name].double() - f.double()).abs().max() / f.double().abs().max().clamp(
            min=1e-30)
        field_gap = max(field_gap or 0.0, float(g))
    ints = [(got["step"], want["step"]), (got["overflow"], want["overflow"])]
    ints += [(got["health"][k], v) for k, v in want["health"].items()]
    count_off = sum(int(a != b) for a, b in ints)
    count_off += int((got["rng"] != want["rng"]).sum())
    for name, v in want_obs.items():
        count_off += int((got_obs[name].to(torch.int64).reshape(-1).cpu()
                          != v.reshape(-1).cpu()).sum())
    return {"rows_off": float(off.double().mean()), "pos_gap_um": float(gap.max()),
            "field_gap": field_gap, "count_off": count_off}


def merge(readings: list) -> dict:
    """The worst of several checked steps' numbers."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if v is not None:
                out[k] = v if k not in out else max(out[k], v)
    return out


def load_limits(root: Path, workload: str) -> dict:
    path = root / "checks" / f"{workload}.json"
    return json.loads(path.read_text())["limits"]


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every limited number at or
    under its limit; a number that is missing fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, shown
