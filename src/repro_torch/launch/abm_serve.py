"""ABM session server: continuous batching over a fixed simulation slot pool.

    PYTHONPATH=src python -m repro_torch.launch.abm_serve --sessions 6 --slots 4 \\
        --steps 24 --chunk 8                          # on the card
    PYTHONPATH=src python -m repro_torch.launch.abm_serve --smoke --device cpu

Port of ``repro/launch/abm_serve.py``.  B independent simulation sessions
share one batched step (:class:`~repro_torch.core.batch.BatchedSimulation`),
and this module runs the LM decode loop's continuous-batching idiom over it
— a fixed slot pool stepped in fixed-size chunks, with session lifecycle
handled host-side *between* chunks:

  * admit — a queued request fills a free slot by checkpoint-grade state
    injection (a fresh seeded state, or a resumed checkpoint the caller
    passes in), budgeted to its requested step count;
  * harvest — each chunk's per-slot observable rows are appended to the
    session's series (frequency-k firing rides each slot's own absolute
    step counter, so the concatenation is bit-identical to a solo run);
  * retire — a session that reaches its budget returns its results and
    frees the slot;
  * evict — a slot whose per-slot :class:`~repro_torch.core.schedule.HealthReport`
    shows non-finite state is removed with status ``"evicted"`` (slots are
    independent, so the NaN cannot leak across them; eviction is about not
    wasting the slot).

Each chunk runs through the compiled batched run
(:meth:`~repro_torch.core.batch.BatchedSimulation.run_jit`): the step
replayed from CUDA graphs, and a chunk whose first step's key has a graph
starts with a replay.  The port adds ``--device`` (default: the card).
Per-chunk telemetry (occupancy, admits/retires/evictions, steps/sec) goes
to stdout; ``serve()`` is the programmatic surface.  ``launch/serve.py`` is
the LM-side sibling.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class SessionRequest:
    """One queued simulation session.

    ``seed``/``params`` build a fresh session from the served model's
    template (``params`` in the solo override namespace of
    :meth:`~repro_torch.core.batch.BatchedSimulation.session_state`);
    ``state`` instead injects an explicit (e.g. checkpoint-restored) state,
    validated against the model at admission.  ``n_steps`` is the absolute
    target step counter — a resumed state runs only the remainder.
    """

    name: str
    n_steps: int
    seed: Optional[int] = None
    params: Optional[Dict[str, Any]] = None
    state: Any = None


@dataclasses.dataclass
class SessionResult:
    """status ``"done"`` (budget reached) or ``"evicted"`` (health); ``obs``
    holds the concatenated per-chunk series (numpy), ``final`` the
    checkpoint-grade final state (resumable via a new request's
    ``state=``)."""

    name: str
    status: str
    steps: int
    obs: Dict[str, np.ndarray]
    health: Dict[str, int]
    final: Any


def _unhealthy(health: Dict[str, int]) -> bool:
    return health["nonfinite_agents"] > 0 or health["nonfinite_steps"] > 0


def serve(
    built,
    requests: Sequence[SessionRequest],
    slots: int = 4,
    chunk: int = 8,
    evict_unhealthy: bool = True,
    log: Optional[Callable[[str], None]] = print,
) -> List[SessionResult]:
    """Drive every request through the slot pool; returns results in
    completion order.  ``built`` is a :class:`~repro_torch.core.api.BuiltSimulation`
    (the model every session runs, on its device; per-session variation
    comes from the request's seed/params/state)."""
    eng = built.batched()
    say = log or (lambda s: None)
    bstate = eng.empty_state(slots)
    queue: List[SessionRequest] = list(requests)
    sessions: List[Optional[dict]] = [None] * slots  # per-slot live session
    results: List[SessionResult] = []
    n_chunks = 0
    t_serve = time.time()

    def admit() -> int:
        nonlocal bstate
        admitted = 0
        for slot in range(slots):
            if sessions[slot] is not None or not queue:
                continue
            req = queue.pop(0)
            state = req.state
            if state is None:
                state = eng.session_state(seed=req.seed, params=req.params)
            start = int(state.step)
            budget = int(req.n_steps) - start
            if budget <= 0:
                raise ValueError(
                    f"session {req.name!r}: n_steps={req.n_steps} but the "
                    f"injected state is already at step {start}"
                )
            bstate = eng.inject(bstate, slot, state, budget=budget)
            sessions[slot] = {"req": req, "obs": {}, "start": start}
            admitted += 1
        return admitted

    def harvest(slot: int, obs, fired: Dict[str, List[int]]) -> None:
        acc = sessions[slot]["obs"]
        for name, rows in obs.items():
            n = fired[name][slot]
            if n:
                new = rows[slot][:n].cpu().numpy()
                acc[name] = np.concatenate([acc[name], new]) if name in acc else new

    def close(slot: int, status: str) -> None:
        nonlocal bstate
        state, bstate = eng.evict(bstate, slot)
        sess = sessions[slot]
        sessions[slot] = None
        health = {f.name: int(getattr(state.health, f.name))
                  for f in dataclasses.fields(state.health)}
        results.append(SessionResult(
            name=sess["req"].name, status=status, steps=int(state.step),
            obs=sess["obs"], health=health, final=state,
        ))

    while queue or any(s is not None for s in sessions):
        admitted = admit()
        pre_steps = bstate.states.step.tolist()
        t0 = time.time()
        bstate, obs, counts = eng.run_jit(bstate, chunk)
        post_steps = bstate.states.step.tolist()
        wall = time.time() - t0
        n_chunks += 1

        # One read each for the rows written, the budgets and the health.
        fired = {name: c.tolist() for name, c in counts.items()}
        stop = bstate.stop_step.tolist()
        health = bstate.states.health
        rows = {f.name: getattr(health, f.name).tolist() for f in dataclasses.fields(health)}
        retired = evicted = 0
        for slot in range(slots):
            if sessions[slot] is None:
                continue
            harvest(slot, obs, fired)
            if evict_unhealthy and _unhealthy({k: v[slot] for k, v in rows.items()}):
                close(slot, "evicted")
                evicted += 1
            elif post_steps[slot] >= stop[slot]:
                close(slot, "done")
                retired += 1
        occupancy = sum(s is not None for s in sessions)
        steps = sum(b - a for a, b in zip(pre_steps, post_steps))
        say(
            f"chunk {n_chunks:3d}: occupancy {occupancy}/{slots} "
            f"(+{admitted} admitted, {retired} retired, {evicted} evicted) "
            f"advanced {steps} steps in {wall:.3f}s "
            f"({steps / max(wall, 1e-9):.0f} steps/s)"
        )

    wall = time.time() - t_serve
    n_done = sum(r.status == "done" for r in results)
    n_evicted = len(results) - n_done
    say(
        f"served {len(results)} sessions ({n_done} done, {n_evicted} "
        f"evicted) over {n_chunks} chunks in {wall:.2f}s "
        f"({len(results) / max(wall, 1e-9):.2f} sims/s)"
    )
    return results


def _series_sha(obs: Dict[str, Any]) -> str:
    """SHA-256 of a session's series (sorted by name; numpy or tensors)."""
    h = hashlib.sha256()
    for name in sorted(obs):
        h.update(name.encode())
        v = obs[name]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _demo_model(smoke: bool, device=None):
    """Small SIR scenario on the facade (the reference's demo shape)."""
    from repro_torch.core import ForceParams, behaviors
    from repro_torch.core.api import Simulation

    n = 24 if smoke else 64
    rng = np.random.default_rng(0)
    position = rng.uniform(0.0, 30.0, (n, 3))
    kind = np.zeros(n, np.int32)
    kind[: max(n // 16, 1)] = 1  # seed infections
    return (
        Simulation(space=30.0, cell_size=5.0, boundary="toroidal", dt=1.0,
                   capacity=n, max_per_cell=8, sort_frequency=8, seed=0, device=device)
        .add_agents(position=position, kind=kind, diameter=1.0)
        .use(behaviors.random_movement(1.2),
             behaviors.sir_infection(4.0, 0.15),
             behaviors.sir_recovery(0.05))
        .mechanics(ForceParams())
        .observe_kinds(n_kinds=3, frequency=4)
        .build()
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ABM session server demo: continuous batching of "
        "independent SIR sessions over a fixed slot pool (see module "
        "docstring; launch/serve.py is the LM decode sibling)."
    )
    ap.add_argument("--sessions", type=int, default=6,
                    help="number of queued session requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool width (batch size of the batched step)")
    ap.add_argument("--steps", type=int, default=24,
                    help="per-session step budget")
    ap.add_argument("--chunk", type=int, default=8,
                    help="steps per serving chunk (admit/evict boundary)")
    ap.add_argument("--smoke", action="store_true",
                    help="shrunk scenario for CI")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card; fails without one) or 'cpu'")
    args = ap.parse_args(argv)

    built = _demo_model(args.smoke, args.device)
    requests = [
        SessionRequest(name=f"user{i}", n_steps=args.steps, seed=100 + i)
        for i in range(args.sessions)
    ]
    results = serve(built, requests, slots=args.slots, chunk=args.chunk)

    # The serving guarantee, demonstrated: each session's series is
    # bit-identical to a solo run of the same seed.
    eng = built.batched()
    for r in sorted(results, key=lambda r: r.name):
        _, solo_obs = built.run_jit(
            args.steps, state=eng.session_state(seed=int(r.name[4:]) + 100))
        solo_sha = _series_sha(solo_obs)
        sha = _series_sha(r.obs)
        tag = "== solo" if sha == solo_sha else "!= solo (MISMATCH)"
        print(f"{r.name}: {r.status} after {r.steps} steps, "
              f"series sha256={sha[:16]} {tag}")
        if sha != solo_sha:
            raise SystemExit(f"{r.name} diverged from its solo run")
    print("abm serving OK")


if __name__ == "__main__":
    main()
