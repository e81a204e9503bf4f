"""Fault tolerance + elastic scaling policy of the single-node engine.

Port of ``repro.launch.elastic`` (DESIGN.md §7).

Failure model & responses
-------------------------
1. **Process/host death mid-run** — ``Simulation.run(...,
   checkpoint_dir=)`` persists the full run (state + observable rows)
   atomically every interval, and ``Simulation.resume(dir)`` finishes the
   run bit for bit (per-step RNG folds the absolute step counter).
2. **Capacity saturation** — pools are fixed-capacity; saturation sets
   counters instead of corrupting the step (``pool.overflow``), folded into
   ``state.health`` by the scheduler's health op.  :func:`check_abm_state`
   turns a host-side read of that report into an :class:`ElasticAction`;
   :func:`run_elastic` responds by restoring the latest checkpoint into a
   ``grow_factor``×-larger pool (:func:`grow_state`: surviving agents
   bit-identical, dead padding) and replaying the saturated chunk.
   Cell-list overflow is *not* a regrow trigger: the dense fallback keeps
   the physics exact, so it is a performance signal only.
3. **Numerical corruption** — non-finite positions/attrs trip
   ``health.nonfinite_agents``; growing cannot fix NaNs, so the policy
   halts with the counts named.
4. **Host failure under a mesh** — the largest surviving power-of-two mesh
   (:func:`surviving_mesh_shape`) and the plan to re-shard the latest
   checkpoint onto it (:func:`reshard_plan`).

The distributed engine regrows the same way (:func:`grow_dist_state`,
:func:`run_elastic_distributed`), its exchange buffers with its pools.  The
policy layer imports no torch at module scope.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

# The HealthReport counters the policy reads.
_POLICY_COUNTERS = ("nonfinite_agents", "nonfinite_steps", "pool_overflow",
                    "migrate_overflow", "halo_overflow")


@dataclasses.dataclass(frozen=True)
class ElasticAction:
    kind: str          # "continue" | "grow_capacity" | "halt" | "rebuild_mesh"
    reason: str = ""
    grow_factor: float = 1.0


def _read_counts(health) -> Dict[str, int]:
    """Each policy counter summed over any leading device axis, in one
    device-to-host read for tensor reports; a missing attribute reads 0."""
    values = {name: getattr(health, name, 0) for name in _POLICY_COUNTERS}
    tensors = [name for name, v in values.items() if hasattr(v, "detach")]
    counts = {name: int(np.asarray(v).sum()) for name, v in values.items()
              if name not in tensors}
    if tensors:
        import torch

        sums = torch.stack([values[n].reshape(-1).sum().to(torch.int64) for n in tensors])
        counts.update(zip(tensors, sums.tolist()))
    return counts


def check_abm_state(health, grow_factor: float = 2.0) -> ElasticAction:
    """Turn a host-side read of the health report into a policy decision.

    Duck-typed: anything carrying the
    :class:`~repro_torch.core.schedule.HealthReport` counter attributes
    works — a per-device stacked report sums across devices, and missing
    attributes read as zero.  Priorities: non-finite agent state halts;
    any saturation counter asks for a capacity regrow; cell-list overflow
    alone continues (the dense fallback already kept the step exact).
    """
    c = _read_counts(health)
    if c["nonfinite_agents"] > 0:
        return ElasticAction(
            "halt",
            f"{c['nonfinite_agents']} agents with non-finite state across "
            f"{c['nonfinite_steps']} flagged steps — growing "
            f"capacity cannot fix numerical corruption",
        )
    if c["pool_overflow"] > 0:
        return ElasticAction(
            "grow_capacity", f"agent pool overflowed by {c['pool_overflow']}", grow_factor
        )
    mig, halo = c["migrate_overflow"], c["halo_overflow"]
    if mig > 0 or halo > 0:
        return ElasticAction(
            "grow_capacity",
            f"exchange buffers overflowed (migrate {mig}, halo {halo})",
            grow_factor,
        )
    return ElasticAction("continue")


# ---------------------------------------------------------------------------
# Regrowth: restore a checkpoint into larger pools
# ---------------------------------------------------------------------------


def grow_pool(pool, new_capacity: int, axis: int = 0):
    """Pad the pool's agent axis to ``new_capacity`` with dead slots, on the
    pool's device.

    Surviving-agent rows are bit-identical; padding matches ``make_pool``'s
    (zero values, ``alive=False``).  ``overflow`` resets — it counted drops
    against the old capacity.  ``axis=1`` serves a stacked pool with a
    leading device axis.
    """
    import torch

    old = pool.position.shape[axis]
    if new_capacity < old:
        raise ValueError(f"cannot shrink pool capacity {old} → {new_capacity}")

    def _pad(x):
        shape = list(x.shape)
        shape[axis] = new_capacity - old
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    return pool.replace(
        position=_pad(pool.position),
        diameter=_pad(pool.diameter),
        kind=_pad(pool.kind),
        age=_pad(pool.age),
        alive=_pad(pool.alive),
        static=_pad(pool.static),
        attrs={k: _pad(v) for k, v in pool.attrs.items()},
        overflow=torch.zeros_like(pool.overflow),
    )


def grow_state(state, new_capacity: int):
    """Single-node regrow: pool padded to ``new_capacity``, health report
    reset (it described the saturated run being rolled back), both on the
    pool's device."""
    from repro_torch.core.schedule import empty_health

    return dataclasses.replace(
        state,
        pool=grow_pool(state.pool, new_capacity, axis=0),
        health=empty_health(state.pool.device),
    )


def grow_dist_state(state, new_capacity: int, new_dcfg):
    """Distributed regrow: per-rank pool rows padded to ``new_capacity``,
    fresh halo-codec buffers and ghost frame at the new halo capacity (the
    codec's ``prev_ids`` freshness bits make a reset safe: the first exchange
    after it ships full precision), exchange counters and health reset, on
    the state's device.  The cumulative wire-byte counters are kept."""
    import torch

    from repro_torch.core.distributed import GhostFrame, HaloCodecState, replicate
    from repro_torch.core.schedule import empty_health

    device = state.pool.device
    n_dev = state.pool.position.shape[0]
    scale = float(state.codec.scale.reshape(-1)[0])
    codec1 = HaloCodecState.create(new_dcfg.n_decomposed, new_dcfg.halo_capacity, scale,
                                   device)
    zeros = torch.zeros((n_dev,), dtype=torch.int32, device=device)
    return dataclasses.replace(
        state,
        pool=grow_pool(state.pool, new_capacity, axis=1),
        codec=replicate(codec1, n_dev),
        migrate_overflow=zeros,
        halo_overflow=zeros.clone(),
        health=replicate(empty_health(device), n_dev),
        # The aura frame sizes with halo_capacity; a zeroed frame is safe —
        # every step's exchange rewrites it before any op reads it.
        ghost=replicate(GhostFrame.create(new_dcfg, device), n_dev),
    )


# ---------------------------------------------------------------------------
# Elastic run: run → inspect health → (commit | regrow-and-replay)
# ---------------------------------------------------------------------------


def run_elastic(
    sim,
    n_steps: int,
    checkpoint_dir: str,
    checkpoint_every: Optional[int] = None,
    grow_factor: float = 2.0,
    max_regrows: int = 3,
    jit: bool = True,
    seed: Optional[int] = None,
    keep: int = 3,
):
    """Saturation-driven elastic run on the single-node engine.

    Runs in ``checkpoint_every``-step chunks.  After each chunk the health
    report is read host-side; on saturation the chunk is *not* committed —
    the latest checkpoint (written before it) is restored, the facade is
    rebuilt with ``capacity = ⌈grow_factor × old⌉``, the restored state is
    padded into the bigger pool (:func:`grow_state`), and the chunk
    replays.  Returns ``(final_state, {name: rows}, n_regrows)``; raises
    ``RuntimeError`` on a halt action or when ``max_regrows`` is exhausted.
    ``jit`` runs each chunk through ``BuiltSimulation.run_jit`` (the
    compiled runner, whose graphs every chunk of one capacity replays),
    else through ``run``.  The step counter and the health report are each
    read from the device once a chunk.
    """
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.api import _concat_obs, _obs_tensors, _step_of

    built = sim.build(seed=seed)
    every = int(checkpoint_every) if checkpoint_every else int(n_steps)
    if every <= 0:
        raise ValueError(f"checkpoint_every must be positive, got {every}")
    state = built.state
    acc: Dict[str, np.ndarray] = {}
    step = _step_of(state)
    target = step + int(n_steps)
    grows = 0

    def save(st, at):
        ckpt.save(checkpoint_dir, at, {"state": st, "obs": acc}, keep=keep)

    save(state, step)
    while step < target:
        runner = built.run_jit if jit else built.run
        new_state, obs = runner(min(every, target - step), state=state)
        action = check_abm_state(new_state.health, grow_factor)
        if action.kind == "halt":
            raise RuntimeError(
                f"elastic run halted at step {_step_of(new_state)}: {action.reason}"
            )
        if action.kind == "grow_capacity":
            if grows >= max_regrows:
                raise RuntimeError(
                    f"still saturated after {grows} regrows: {action.reason}"
                )
            grows += 1
            new_cap = int(math.ceil(state.pool.capacity * action.grow_factor))
            _, payload = ckpt.restore(checkpoint_dir, {"state": state, "obs": acc})
            sim.capacity = new_cap
            built = sim.build(seed=seed)
            state = grow_state(payload["state"], new_cap)
            save(state, step)              # re-anchor at the new capacity
            continue                       # replay the chunk, bigger pool
        state = new_state
        acc = _concat_obs(acc, obs)
        step = _step_of(state)
        save(state, step)
    return state, _obs_tensors(acc, state.pool.device), grows


def run_elastic_distributed(
    sim,
    mesh,
    dcfg,
    n_steps: int,
    checkpoint_dir: str,
    checkpoint_every: Optional[int] = None,
    grow_factor: float = 2.0,
    max_regrows: int = 3,
    seed: Optional[int] = None,
    keep: int = 3,
    capacity: Optional[int] = None,
    jit: bool = False,
):
    """Distributed counterpart of :func:`run_elastic`.

    A regrow scales the per-rank pool capacity AND the exchange-buffer
    bounds (``halo_capacity`` / ``migrate_capacity``) by ``grow_factor``,
    re-deploys through ``sim.distribute`` on the grown ``DomainConfig``, and
    pads the restored state into the new shapes (:func:`grow_dist_state`).
    ``jit=True`` runs each chunk through ``DistributedSimulation.run_jit``
    (the deployment's runner, so the chunks between regrows replay its
    graphs).  Returns ``(final_state, {name: rows}, n_regrows)``.

    On a process mesh every process calls it alike and gets the same
    result: each decides from the gathered stacked health, so all take the
    same action; rank 0 writes the checkpoints and the processes meet at a
    barrier after each; a regrow has rank 0 restore the checkpoint and
    broadcast it (a failed restore raises on every process), and each
    process re-deploys on the same mesh with the grown ``DomainConfig``.
    """
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.api import _concat_obs, _obs_tensors, _step_of

    dsim = sim.distribute(mesh, dcfg, capacity=capacity, seed=seed)
    every = int(checkpoint_every) if checkpoint_every else int(n_steps)
    if every <= 0:
        raise ValueError(f"checkpoint_every must be positive, got {every}")
    state = dsim.state
    acc: Dict[str, np.ndarray] = {}
    step = _step_of(state)
    target = step + int(n_steps)
    grows = 0

    def save(st, at):
        if mesh.writes_checkpoints:
            ckpt.save(checkpoint_dir, at, {"state": st, "obs": acc}, keep=keep)
        mesh.barrier()

    def restore(like):
        def latest():
            return None, ckpt.restore(checkpoint_dir, {"state": like, "obs": acc})[1]["state"]

        return mesh.from_first(latest, like)[1] if mesh.process else latest()[1]

    save(state, step)
    while step < target:
        run = dsim.run_jit if jit else dsim.run
        new_state, obs = run(min(every, target - step), state=state)
        action = check_abm_state(new_state.health, grow_factor)
        if action.kind == "halt":
            raise RuntimeError(
                f"elastic run halted at step {_step_of(new_state)}: {action.reason}"
            )
        if action.kind == "grow_capacity":
            if grows >= max_regrows:
                raise RuntimeError(
                    f"still saturated after {grows} regrows: {action.reason}"
                )
            grows += 1
            g = action.grow_factor
            new_cap = int(math.ceil(state.pool.position.shape[1] * g))
            dcfg = dataclasses.replace(
                dcfg,
                halo_capacity=int(math.ceil(dcfg.halo_capacity * g)),
                migrate_capacity=int(math.ceil(dcfg.migrate_capacity * g)),
            )
            restored = restore(state)
            dsim = sim.distribute(mesh, dcfg, capacity=new_cap, seed=seed)
            state = grow_dist_state(restored, new_cap, dcfg)
            save(state, step)              # re-anchor at the new shapes
            continue
        state = new_state
        acc = _concat_obs(acc, obs)
        step = _step_of(state)
        save(state, step)
    return state, _obs_tensors(acc, state.pool.device), grows


# ---------------------------------------------------------------------------
# Mesh survival (host-failure path, kept for the coordinator)
# ---------------------------------------------------------------------------


def surviving_mesh_shape(n_healthy_hosts: int, devices_per_host: int,
                         model_parallel: int) -> Optional[Tuple[int, int]]:
    """Largest (data, model) mesh fitting the surviving devices.

    Keeps the model axis fixed (TP degree is a property of the model
    sharding) and shrinks the data axis to the largest power of two that
    fits — the checkpoint re-shards onto it."""
    total = n_healthy_hosts * devices_per_host
    if total < model_parallel:
        return None
    data = 1 << int(np.log2(total // model_parallel))
    return (data, model_parallel)


def reshard_plan(old_shape: Tuple[int, int], new_shape: Tuple[int, int]) -> str:
    """Human-readable plan for re-sharding a checkpoint across mesh sizes.

    Checkpoints store full (unsharded) arrays, so re-sharding is loading
    them and placing each shard on its device of the new mesh."""
    return (
        f"restore full arrays from latest manifest; "
        f"shard onto mesh {new_shape} "
        f"(was {old_shape}); data-axis batch size rescales by "
        f"{new_shape[0] / old_shape[0]:.2f}×, lr rescaled accordingly"
    )
