"""TeraAgent: the distributed simulation engine (Chapter 6).

Port of ``repro.core.distributed``.  One simulation is spatially decomposed
over a mesh of ranks: every rank owns a box-shaped subdomain and the agents
inside it (Fig 6.1).  Each iteration needs two kinds of neighbour-rank
communication:

  1. **migration** — agents whose position left the local box move to the
     owning neighbour (full agent record);
  2. **aura / halo exchange** — read-only copies of agents within one
     interaction radius of a face, so local force and behaviour evaluation
     sees the whole neighbourhood (§6.2.1), with attribute subsetting
     (§6.2.2) and the quantized delta codec of ``core/delta.py`` (§6.2.3).

The reference runs one SPMD program over a JAX device mesh.  The port runs
the same step over either of two meshes (``launch/mesh.py``), which it reads
through one interface: ``mesh.local_ranks``, the ranks this process steps,
and :meth:`Mesh.shift`, the ring shift ``_shift``, which takes one value a
local rank.

* An *in-process mesh* (``make_mesh``): R ranks, each a torch device (all
  on ``cuda:0`` with one card), stepped in lock-step, op by op, from one
  host thread.  The shift is a rotation of the ranks' tensors moved to the
  receiver's device.  Lock-step needs no threads or barriers; each rank's
  work runs on its own lanes (``core/lanes.py``: a stream a rank on the
  card, and in the overlapped schedule a second for its exchange), so the
  ranks run side by side, and a shift makes the receiver's lane wait on the
  sender's event.
* A *process mesh* (``process_mesh``): one process a rank over a
  ``torch.distributed`` group (``launch/procs.py`` or ``torchrun``).  Each
  process holds only its own rank's state, on its own device; the shift is
  a ``dist.batch_isend_irecv`` with the ring neighbours (NCCL: device
  tensors; gloo: staged through pinned host memory).  The lists below hold
  one state, indexed by the process's global rank wherever a rank number is
  read (``prng.fold_in``, ``rank_scope``, the axis index).

Every collective lives inside one of three whole ops — ``migrate``,
``halo_exchange`` and the distributed ``diffusion`` — which take the list
of every local rank's state (``Operation.collective``); every other op runs
once a local rank on that rank's state.  A step replaces no rank's state
until every local rank has finished it, so an error in any rank leaves the
caller's state as it was.

The step IS the single-node schedule (``core/schedule.py``):
:func:`distributed_scheduler` takes ``Scheduler.default(ecfg)`` and
inserts ``migrate`` / ``halo_exchange`` after ``sort``, and replaces
``env_build`` / ``boundary`` / ``diffusion`` by their domain-decomposed
variants; behaviours, forces, §5.5 static flags, age and health are the
single-node ops.  The neighbour index is built once over the halo-extended
grid (ghost rows land in its boundary cells) and the force kernels take the
ghost-extended sources with ``num_out = C``.

State is stacked on a leading rank axis (the reference's leaf layout)
wherever it is observed or saved; during a run the executor keeps one
state a local rank (views of the stacked tensors, moved to each rank's
device) and stacks them when an observable fires and at the end of a chunk
(on a process mesh: an all-gather, so every process holds the stacked
state).

All shapes are static: halo and migration buffers have fixed capacities
and overflow *counters*.  Coordinates are rank-local, and the decomposed
dims live on the rank torus.

The compiled run (:func:`jitted_distributed_runner`, the reference's
``jax.jit`` of the step; in-process meshes only) replays the lock-step step
of every rank from CUDA graphs (``core/runner.py``): ``step_ranks`` with
``branches`` hands each rank's ops its device counter, and each rank's
force passes their branches under its own scope.  So the step makes no
host read and no host-to-device copy: scalars are filled on the device, the
interior cell tables are kept device constants, and the grids' ``n_valid``
is a state leaf.

Every op that works for one rank runs under ``rank_scope(r)``, a context
that does nothing unless the dry-run (``launch/dryrun.py``) sets it: there
it counts the op's FLOPs, bytes and storage for rank r, so one rank's share
of the lock-step step is known exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, ContextManager, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import delta as dcodec
from . import diffusion as dgrid
from . import lanes, prng
from .agents import AgentPool, compact_indices, free_slot_table, make_pool, remove_agents
from .behaviors import StepContext
from .engine import EngineConfig, count_kinds
from .forces import Branches
from .grid import GridSpec, build_index_arrays, cell_coords, device_constant, fdiv
from .neighbors import NeighborContext
from .schedule import (
    HealthReport,
    Operation,
    OpContext,
    Scheduler,
    apply_boundary,
    apply_force,
    empty_health,
    force_pass,
)
from .slots import tree_map
from .spans import span

WIRE_DTYPES = {"int16": torch.int16, "int8": torch.int8}
HALO_CODECS = ("none",) + tuple(WIRE_DTYPES)


def _no_scope(rank: int) -> ContextManager:
    return contextlib.nullcontext()


# ``rank_scope(r)``: the context in which rank r's own work runs (see the
# module docstring); the dry-run swaps in its per-rank counter.
rank_scope: Callable[[int], ContextManager] = _no_scope


@contextlib.contextmanager
def _on_rank(rank: int):
    """Rank ``rank``'s own work: in its lane of the running step
    (``core/lanes.py``), under ``rank_scope``."""
    with lanes.entered(rank), rank_scope(rank):
        yield


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """Static spatial-decomposition description.

    mesh_axes:   mesh axis names decomposing space, in (x, y[, z]) order.
    axis_sizes:  mesh extent along each of those axes.
    extent:      local subdomain edge length along each decomposed dim.
    depth:       edge length of non-decomposed dims (2D decomposition only).
    halo_width:  aura width == interaction radius.
    halo_capacity / migrate_capacity: per-direction buffer bounds.
    halo_codec:  "none" (f32 wire) | "int16" | "int8" (§6.2.3 delta codec).
    overlap_halo: split the force op into an interior pass over a
                 local-only index (no ghost reads) and a boundary-shell pass
                 over the ghost-extended one; bit-identical to the serial
                 schedule.  The halo exchange and the ghost-extended build
                 run in each rank's exchange lane, beside the interior pass
                 on its compute lane; the first op that reads what they made
                 (the shell pass, or a behaviour reading neighbours) joins
                 the exchange (``core/lanes.py``, :func:`overlap_report`).
    """

    mesh_axes: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    extent: float
    halo_width: float
    halo_capacity: int
    migrate_capacity: int
    depth: float = 0.0
    halo_codec: str = "int16"
    overlap_halo: bool = False

    def __post_init__(self):
        if self.halo_codec not in HALO_CODECS:
            raise ValueError(f"unknown halo_codec {self.halo_codec!r}; expected {HALO_CODECS}")
        if len(self.mesh_axes) != len(self.axis_sizes) or not 1 <= len(self.mesh_axes) <= 3:
            raise ValueError(f"mesh_axes {self.mesh_axes} and axis_sizes {self.axis_sizes} "
                             f"must name 1 to 3 decomposed dims")

    @property
    def n_decomposed(self) -> int:
        return len(self.mesh_axes)

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.axis_sizes))

    def local_extent(self, dim: int) -> float:
        return self.extent if dim < self.n_decomposed else self.depth

    def ghost_capacity(self, pool_capacity: int) -> int:
        return pool_capacity + 2 * self.n_decomposed * self.halo_capacity

    def grid_spec(self, box_size: float, max_per_cell: int,
                  use_morton: bool = True, rank_impl: str = "tiled") -> GridSpec:
        """Grid over the halo-extended local domain."""
        origin = []
        dims = []
        for d in range(3):
            lo = -self.halo_width if d < self.n_decomposed else 0.0
            hi = self.local_extent(d) + (self.halo_width if d < self.n_decomposed else 0.0)
            origin.append(lo)
            dims.append(max(int(math.ceil((hi - lo) / box_size)), 1))
        return GridSpec(origin=tuple(origin), box_size=box_size, dims=tuple(dims),
                        max_per_cell=max_per_cell, use_morton=use_morton,
                        rank_impl=rank_impl)

    def device_coords(self, dev: int) -> Tuple[int, ...]:
        """Mesh coordinates of linear rank ``dev``: the x-major
        (``mesh_axes``-order) linearization shared by agent binning and the
        facade's substance splitting."""
        coords = []
        for d in reversed(range(self.n_decomposed)):
            coords.append(dev % self.axis_sizes[d])
            dev //= self.axis_sizes[d]
        return tuple(coords[::-1])


@dataclasses.dataclass(frozen=True)
class HaloCodecState:
    """Per-rank delta-codec state for all (dim, direction) halo channels.

    send_ref / recv_ref: (D, 2, H, 3) f32 — receiver reconstructions.
    prev_ids:            (D, 2, H) i32 — previous slot occupants (freshness).
    scale:               () f32.
    """

    send_ref: torch.Tensor
    recv_ref: torch.Tensor
    prev_ids: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def create(n_dims: int, capacity: int, scale: float,
               device: torch.device | str = "cpu") -> "HaloCodecState":
        return HaloCodecState(
            send_ref=torch.zeros((n_dims, 2, capacity, 3), dtype=torch.float32, device=device),
            recv_ref=torch.zeros((n_dims, 2, capacity, 3), dtype=torch.float32, device=device),
            prev_ids=torch.full((n_dims, 2, capacity), -1, dtype=torch.int32, device=device),
            scale=torch.tensor(scale, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class GhostFrame:
    """The aura snapshot: the 2·D·H halo rows of the latest
    ``halo_exchange``, receiver-frame rebased, in (dim, direction) channel
    order after the C local rows.  ``halo_exchange`` writes it each step;
    the overlapped schedule's ghost-extended build reads it."""

    position: torch.Tensor  # (2·D·H, 3) f32
    radius: torch.Tensor    # (2·D·H,)   f32
    kind: torch.Tensor      # (2·D·H,)   i32
    alive: torch.Tensor     # (2·D·H,)   bool

    @staticmethod
    def create(dcfg: DomainConfig, device: torch.device | str = "cpu") -> "GhostFrame":
        n = 2 * dcfg.n_decomposed * dcfg.halo_capacity
        return GhostFrame(
            position=torch.zeros((n, 3), dtype=torch.float32, device=device),
            radius=torch.zeros((n,), dtype=torch.float32, device=device),
            kind=torch.zeros((n,), dtype=torch.int32, device=device),
            alive=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass(frozen=True)
class DistState:
    """Per-rank simulation state (stacked on a leading rank axis when
    observed or saved).

    halo_payload_bytes / halo_baseline_bytes: cumulative per-rank wire-byte
    account of ``halo_exchange`` — payload is what the codec ships, baseline
    the f32 full-attribute record.  i32 like the overflow counters; they
    wrap after ~2 GiB of traffic (read and reset between epochs).
    """

    pool: AgentPool
    grids: Dict[str, dgrid.DiffusionGrid]
    codec: HaloCodecState
    rng: torch.Tensor                 # (2,) uint32 key data
    step: torch.Tensor                # () i32
    migrate_overflow: torch.Tensor    # () i32
    halo_overflow: torch.Tensor       # () i32
    halo_payload_bytes: torch.Tensor  # () i32
    halo_baseline_bytes: torch.Tensor  # () i32
    health: HealthReport
    ghost: GhostFrame


def stack_states(states: Sequence[DistState], device=None, mesh=None) -> DistState:
    """The ranks' states stacked on a leading rank axis, on ``device``
    (default: rank 0's).  On a process mesh ``states`` is this process's one
    rank and the stack is an all-gather of every leaf in rank order, on the
    process's device."""
    if mesh is not None and mesh.process:
        return mesh.all_gather(states[0])
    dev = states[0].pool.device if device is None else device
    return tree_map(lambda *xs: torch.stack([x.to(dev) for x in xs]), *states)


def replicate(tree, n: int):
    """``tree`` with every leaf stacked ``n`` times on a new leading axis."""
    return tree_map(lambda x: torch.stack([x] * n), tree)


def unstack_state(state: DistState, devices) -> List[DistState]:
    """One state a rank: views of the stacked leaves (copies on another
    device).  ``devices``: one device a rank, or a mesh; a process mesh keeps
    only its process's rank, on its device."""
    if getattr(devices, "process", False):
        r, dev = devices.rank, devices.device
        return [tree_map(lambda x: x[r].to(dev), state)]
    devices = getattr(devices, "devices", devices)
    return [tree_map(lambda x, r=r: x[r].to(dev), state) for r, dev in enumerate(devices)]


# ---------------------------------------------------------------------------
# Packing helpers (the "tailored serialization", §6.2.2)
# ---------------------------------------------------------------------------


def _select(mask: torch.Tensor, capacity: int):
    """Deterministic compaction of up to ``capacity`` set indices, in index
    order (cumsum rank + scatter).  Invalid ranks point at index 0 (a real
    row; consumers mask with ``valid``).  Returns (ids, valid, overflow)."""
    ids, valid, n = compact_indices(mask, capacity)
    return ids, valid, torch.clamp(n - capacity, min=0)


def _put(dst: torch.Tensor, target: torch.Tensor, src) -> torch.Tensor:
    """``dst.at[target].set(src, mode="drop")`` with ``target`` = C for a
    dropped write (a spare row, cut off).  A Python scalar ``src`` is filled
    on the device, not copied from the host."""
    if isinstance(src, (bool, int, float)):
        src = torch.full((), src, dtype=dst.dtype, device=dst.device)
    else:
        src = torch.as_tensor(src, dtype=dst.dtype, device=dst.device)
    out = torch.cat([dst, dst[:1]], dim=0)
    out[target] = src.expand((target.shape[0],) + tuple(dst.shape[1:]))
    return out[: dst.shape[0]]


def _insert_records(pool: AgentPool, rec: Dict, valid: torch.Tensor) -> AgentPool:
    """Insert up to R received agent records into free pool slots: the
    k-th valid record takes the k-th free slot; the rest are counted in
    ``overflow``."""
    c = pool.capacity
    n_valid = valid.sum(dtype=torch.int32)
    n_free = (~pool.alive).sum(dtype=torch.int32)
    free_slots = free_slot_table(pool.alive)
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    fits = valid & (rank < n_free)
    target = torch.where(fits, free_slots[torch.clamp(rank, 0, c - 1).long()], c).long()
    return pool.replace(
        position=_put(pool.position, target, rec["position"]),
        diameter=_put(pool.diameter, target, rec["diameter"]),
        kind=_put(pool.kind, target, rec["kind"]),
        age=_put(pool.age, target, rec["age"]),
        alive=_put(pool.alive, target, True),
        static=_put(pool.static, target, False),
        attrs={k: _put(v, target, rec["attrs"][k]) for k, v in pool.attrs.items()},
        overflow=pool.overflow + torch.clamp(n_valid - n_free, min=0),
    )


def _pack_records(pool: AgentPool, ids: torch.Tensor, valid: torch.Tensor) -> Dict:
    i = ids.long()
    take = lambda x: x[i]
    return dict(
        position=take(pool.position),
        diameter=torch.where(valid, take(pool.diameter), 0.0),
        kind=torch.where(valid, take(pool.kind), 0),
        age=torch.where(valid, take(pool.age), 0.0),
        attrs={k: take(v) for k, v in pool.attrs.items()},
    )


def _rebase(position: torch.Tensor, d: int, offset: float) -> torch.Tensor:
    """``position.at[:, d].add(offset)``."""
    out = position.clone()
    out[:, d] = out[:, d] + offset
    return out


# ---------------------------------------------------------------------------
# Migration (§6.2.1 repartitioning)
# ---------------------------------------------------------------------------


def _pack_outbound(dcfg: DomainConfig, pool: AgentPool, d: int):
    """One rank's agents that left its box along dim ``d``, packed east- and
    west-bound (rebased into the receiver's frame) and removed from its pool:
    ``(pool, east records, east valid, west records, west valid, overflow)``."""
    ext = dcfg.extent
    coord = pool.position[:, d]
    ids_e, val_e, ovf_e = _select(pool.alive & (coord >= ext), dcfg.migrate_capacity)
    ids_w, val_w, ovf_w = _select(pool.alive & (coord < 0.0), dcfg.migrate_capacity)
    rec_e = _pack_records(pool, ids_e, val_e)
    rec_w = _pack_records(pool, ids_w, val_w)
    # Rebase into the receiving rank's frame (torus).
    rec_e["position"] = _rebase(rec_e["position"], d, -ext)
    rec_w["position"] = _rebase(rec_w["position"], d, ext)
    # Remove exactly the packed agents (index_fill_: a scalar written
    # through an index tensor would be copied from the host).
    c = pool.capacity
    sent = torch.zeros((c + 1,), dtype=torch.bool, device=pool.device)
    sent.index_fill_(0, torch.where(val_e, ids_e, c).long(), True)
    sent.index_fill_(0, torch.where(val_w, ids_w, c).long(), True)
    return remove_agents(pool, sent[:c]), rec_e, val_e, rec_w, val_w, ovf_e + ovf_w


def migrate(dcfg: DomainConfig, mesh, pools: Sequence[AgentPool]
            ) -> Tuple[List[AgentPool], List[torch.Tensor]]:
    """Dimension-ordered migration of agents that left the local box, over
    every local rank's pool; returns the new pools and each rank's
    overflow."""
    pools = list(pools)
    ranks = mesh.local_ranks
    overflow = []
    for r, pool in zip(ranks, pools):
        with _on_rank(r):
            overflow.append(torch.zeros((), dtype=torch.int32, device=pool.device))
    for d in range(dcfg.n_decomposed):
        axis = dcfg.mesh_axes[d]
        east_recs, east_valid, west_recs, west_valid = [], [], [], []
        for i, (r, pool) in enumerate(zip(ranks, pools)):
            with _on_rank(r):
                pools[i], rec_e, val_e, rec_w, val_w, ovf = _pack_outbound(dcfg, pool, d)
                overflow[i] = overflow[i] + ovf
            east_recs.append(rec_e)
            east_valid.append(val_e)
            west_recs.append(rec_w)
            west_valid.append(val_w)
        # Ring exchange: east-bound records shift +1, west-bound −1.
        from_west = mesh.shift(east_recs, axis, +1)
        from_west_valid = mesh.shift(east_valid, axis, +1)
        from_east = mesh.shift(west_recs, axis, -1)
        from_east_valid = mesh.shift(west_valid, axis, -1)
        for i, r in enumerate(ranks):
            with _on_rank(r):
                pools[i] = _insert_records(pools[i], from_west[i], from_west_valid[i])
                pools[i] = _insert_records(pools[i], from_east[i], from_east_valid[i])
    return pools, overflow


# ---------------------------------------------------------------------------
# Aura / halo exchange (§6.2.2 + §6.2.3)
# ---------------------------------------------------------------------------


def _slot_scales(dcfg: DomainConfig, codec: HaloCodecState, fresh: torch.Tensor,
                 wire_dtype) -> torch.Tensor:
    """Two-scale coding: stale slots use the fine scale, fresh slots (new
    occupant, ref reset to 0) a coarse scale whose int range spans the whole
    halo-extended domain.  int16's fine scale already spans it, so only int8
    needs the coarse escape.  Both scales are filled on the device."""
    if wire_dtype == torch.int16:
        return codec.scale
    dev = fresh.device
    coarse = torch.full((), (dcfg.extent + 2.0 * dcfg.halo_width) / 127.0,
                        dtype=torch.float32, device=dev)
    fine = torch.full((), dcfg.halo_width / 127.0, dtype=torch.float32, device=dev)
    return torch.where(fresh[:, None], coarse, fine)


@dataclasses.dataclass
class _Codec:
    """A rank's codec state while ``halo_exchange`` updates it (copies of
    the state's tensors, written channel by channel)."""

    send_ref: torch.Tensor
    recv_ref: torch.Tensor
    prev_ids: torch.Tensor
    scale: torch.Tensor

    @classmethod
    def of(cls, codec: HaloCodecState) -> "_Codec":
        return cls(codec.send_ref.clone(), codec.recv_ref.clone(), codec.prev_ids.clone(),
                   codec.scale)

    def state(self) -> HaloCodecState:
        return HaloCodecState(self.send_ref, self.recv_ref, self.prev_ids, self.scale)


def _codec_encode(dcfg, codec: _Codec, d: int, s: int, pos: torch.Tensor,
                  ids: torch.Tensor, wire_dtype):
    """Delta-encode one channel's positions; returns (payload, fresh)."""
    fresh = ids != codec.prev_ids[d, s]
    ref = torch.where(fresh[:, None], 0.0, codec.send_ref[d, s])
    scale = _slot_scales(dcfg, codec, fresh, wire_dtype)
    q, ch = dcodec.encode(dcodec.DeltaCodec(ref=ref, scale=codec.scale), pos,
                          wire_dtype=wire_dtype, scale=scale)
    codec.send_ref[d, s] = ch.ref
    codec.prev_ids[d, s] = ids
    return q, fresh


def _codec_decode(dcfg, codec: _Codec, d: int, s: int, q: torch.Tensor,
                  fresh: torch.Tensor) -> torch.Tensor:
    ref = torch.where(fresh[:, None], 0.0, codec.recv_ref[d, s])
    scale = _slot_scales(dcfg, codec, fresh, q.dtype)
    pos, ch = dcodec.decode(dcodec.DeltaCodec(ref=ref, scale=codec.scale), q, scale=scale)
    codec.recv_ref[d, s] = ch.ref
    return pos


def halo_exchange(dcfg: DomainConfig, mesh, pools: Sequence[AgentPool],
                  codecs: Sequence[HaloCodecState]):
    """Multi-phase aura exchange over every local rank.

    Returns, a local rank, the ghost-extended ``(position, radius, kind, alive)``
    whose first C rows are the local pool followed by 2·D halo blocks, the
    updated codec state and the overflow count; plus the wire-byte account
    of one rank (the same on every rank: the buffers are fixed-size).
    The dims go in order and each phase's bands include the halo rows of
    the earlier phases, so corner halos ride along."""
    h = dcfg.halo_capacity
    ranks = mesh.local_ranks
    wire = {"payload_bytes": 0, "baseline_bytes": 0}
    wire_dtype = WIRE_DTYPES.get(dcfg.halo_codec)
    bits = lambda k: (k + 7) // 8   # bitmask wire size, ceil (never 0 bytes)

    g_pos = [p.position for p in pools]
    g_kind = [p.kind for p in pools]
    g_alive = [p.alive for p in pools]
    g_rad, codec, overflow = [], [], []
    for r, p, c in zip(ranks, pools, codecs):
        with _on_rank(r):
            g_rad.append(p.radius())
            codec.append(_Codec.of(c))
            overflow.append(torch.zeros((), dtype=torch.int32, device=p.device))
    ext, hw = dcfg.extent, dcfg.halo_width

    for d in range(dcfg.n_decomposed):
        axis = dcfg.mesh_axes[d]
        packs = {0: [], 1: []}
        for j, r in enumerate(ranks):
            with _on_rank(r):
                coord = g_pos[j][:, d]
                east_band = g_alive[j] & (coord >= ext - hw) & (coord < ext)
                west_band = g_alive[j] & (coord >= 0.0) & (coord < hw)
                for s, (band, sign) in enumerate(((east_band, +1), (west_band, -1))):
                    ids, valid, ovf = _select(band, h)
                    overflow[j] = overflow[j] + ovf
                    i = ids.long()
                    pos = _rebase(g_pos[j][i], d, -sign * ext)
                    pos = torch.where(valid[:, None], pos, 0.0)
                    rad = torch.where(valid, g_rad[j][i], 0.0)
                    knd = torch.where(valid, g_kind[j][i], 0).to(torch.int8)
                    if wire_dtype is not None:
                        slot_ids = torch.where(valid, ids, -1)
                        q, fresh = _codec_encode(dcfg, codec[j], d, s, pos, slot_ids, wire_dtype)
                        payload = dict(q=q, fresh=fresh, rad=rad, kind=knd, valid=valid)
                        if j == 0:
                            wire["payload_bytes"] += (
                                q.numel() * q.element_size() + bits(fresh.numel())
                                + rad.numel() * 4 + knd.numel() + bits(valid.numel()))
                    else:
                        payload = dict(pos=pos, rad=rad, kind=knd, valid=valid)
                        if j == 0:
                            wire["payload_bytes"] += (pos.numel() * 4 + rad.numel() * 4
                                                      + knd.numel() + bits(valid.numel()))
                    if j == 0:
                        # Baseline: the f32 full-attribute record (pos, rad, kind).
                        wire["baseline_bytes"] += (pos.numel() * 4 + rad.numel() * 4
                                                   + knd.numel() * 4 + bits(valid.numel()))
                    packs[s].append(payload)

        for s, sign in ((0, +1), (1, -1)):
            got = mesh.shift(packs[s], axis, sign)
            for j, r in enumerate(ranks):
                with _on_rank(r):
                    g = got[j]
                    if wire_dtype is not None:
                        pos = _codec_decode(dcfg, codec[j], d, s, g["q"], g["fresh"])
                    else:
                        pos = g["pos"]
                    g_pos[j] = torch.cat([g_pos[j], pos], dim=0)
                    g_rad[j] = torch.cat([g_rad[j], g["rad"]], dim=0)
                    g_kind[j] = torch.cat([g_kind[j], g["kind"].to(torch.int32)], dim=0)
                    g_alive[j] = torch.cat([g_alive[j], g["valid"]], dim=0)

    out = [(g_pos[j], g_rad[j], g_kind[j], g_alive[j], codec[j].state(), overflow[j])
           for j in range(len(ranks))]
    return out, wire


# ---------------------------------------------------------------------------
# Distributed diffusion (1-voxel stencil halo along decomposed dims)
# ---------------------------------------------------------------------------


def _padding_mask(grid: dgrid.DiffusionGrid) -> Optional[torch.Tensor]:
    """(nx, ny, nz) bool of *valid* voxels, or None without ghost-voxel
    padding (``n_valid`` unset).  Padded voxels lie outside the simulated
    domain and stay ≡ 0."""
    if grid.n_valid is None:
        return None
    shape = grid.concentration.shape
    dev = grid.concentration.device
    nv = grid.n_valid.to(dev)
    mask = torch.ones(shape, dtype=torch.bool, device=dev)
    for d in range(3):
        bshape = [1, 1, 1]
        bshape[d] = shape[d]
        mask = mask & (torch.arange(shape[d], dtype=torch.int32, device=dev)
                       < nv[d]).reshape(bshape)
    return mask


def distributed_diffuse(dcfg: DomainConfig, mesh, grids: Sequence[dgrid.DiffusionGrid],
                        dt: float, boundary: str = "toroidal") -> List[dgrid.DiffusionGrid]:
    """One Eq-4.3 step over every local rank's grid, with the 1-voxel stencil
    halo exchanged over the mesh.

    ``boundary`` is the engine's §4.4.11 policy: "toroidal" keeps the ring
    wrap at the mesh edges; any other value gives the mesh-edge ranks zero
    outside (the single-node engine's boundary).  Ghost-voxel padding
    (``n_valid``) is masked out of the stencil and pinned to zero.  Plain
    PyTorch, as the reference's is plain XLA: the stencil kernel has no
    ghost faces."""
    ranks = mesh.local_ranks
    us, masks, padded = [], [], []
    for r, g in zip(ranks, grids):
        with _on_rank(r):
            u = g.concentration
            mask = _padding_mask(g)
            if mask is not None:
                u = torch.where(mask, u, 0.0)
            padded.append(F.pad(u, (1, 1, 1, 1, 1, 1)))   # zero halo (open in z)
        us.append(u)
        masks.append(mask)
    for d in range(dcfg.n_decomposed):
        axis = dcfg.mesh_axes[d]
        size = dcfg.axis_sizes[d]
        lo_faces = [u.narrow(d, 0, 1) for u in us]
        hi_faces = [u.narrow(d, u.shape[d] - 1, 1) for u in us]
        from_west = mesh.shift(hi_faces, axis, +1)   # west neighbour's top slice
        from_east = mesh.shift(lo_faces, axis, -1)   # east neighbour's bottom
        for j, (r, p) in enumerate(zip(ranks, padded)):
            with _on_rank(r):
                fw, fe = from_west[j], from_east[j]
                if boundary != "toroidal":
                    coord = mesh.axis_index(r, axis)
                    if coord == 0:
                        fw = torch.zeros_like(fw)
                    if coord == size - 1:
                        fe = torch.zeros_like(fe)
                idx_lo = [slice(1, -1)] * 3
                idx_hi = [slice(1, -1)] * 3
                idx_lo[d] = slice(0, 1)
                idx_hi[d] = slice(p.shape[d] - 1, p.shape[d])
                p[tuple(idx_lo)] = fw
                p[tuple(idx_hi)] = fe

    out = []
    for r, g, u, p, mask in zip(ranks, grids, us, padded, masks):
        with _on_rank(r):
            lap = (
                p[2:, 1:-1, 1:-1]
                + p[:-2, 1:-1, 1:-1]
                + p[1:-1, 2:, 1:-1]
                + p[1:-1, :-2, 1:-1]
                + p[1:-1, 1:-1, 2:]
                + p[1:-1, 1:-1, :-2]
                - 6.0 * u
            )
            lap = fdiv(lap, g.spacing**2)
            new = u * (1.0 - g.decay_constant * dt) + g.diffusion_coefficient * dt * lap
            if mask is not None:
                new = torch.where(mask, new, 0.0)
            out.append(dataclasses.replace(g, concentration=new))
    return out


# ---------------------------------------------------------------------------
# The distributed step: the SAME scheduler, distribution expressed as ops
# ---------------------------------------------------------------------------


def migrate_op(dcfg: DomainConfig) -> Operation:
    """§6.2.1 repartitioning as a pre standalone op (collective)."""

    def fn(mesh, ctxs, states):
        pools, ovf = migrate(dcfg, mesh, [s.pool for s in states])
        out = []
        for r, s, p, o in zip(mesh.local_ranks, states, pools, ovf):
            with _on_rank(r):
                out.append(dataclasses.replace(s, pool=p,
                                               migrate_overflow=s.migrate_overflow + o))
        return out

    return Operation("migrate", fn, phase="pre", collective=True)


def halo_exchange_op(dcfg: DomainConfig, lane: str = "compute") -> Operation:
    """§6.2.2/§6.2.3 aura exchange as a pre standalone op (collective).
    Publishes each rank's ghost-extended sources on its context for
    ``env_build``, writes the halo rows into the rank's :class:`GhostFrame`,
    and accounts wire bytes and overflow.  In the ``"exchange"`` lane (the
    overlapped schedule) what it hands on is the lane's product
    (``lanes.product``): a later op joins the lane where it first reads it."""

    def fn(mesh, ctxs, states):
        per_rank, wire = halo_exchange(dcfg, mesh, [s.pool for s in states],
                                       [s.codec for s in states])
        out = []
        for r, ctx, s, (g_pos, g_rad, g_kind, g_alive, codec, ovf) in zip(
                mesh.local_ranks, ctxs, states, per_rank):
            with _on_rank(r):
                ctx.extras["halo_sources"] = lanes.product((g_pos, g_rad, g_kind, g_alive))
                c = s.pool.capacity
                ghost = GhostFrame(position=g_pos[c:], radius=g_rad[c:], kind=g_kind[c:],
                                   alive=g_alive[c:])
                made = dict(
                    codec=codec, ghost=ghost, halo_overflow=s.halo_overflow + ovf,
                    halo_payload_bytes=s.halo_payload_bytes + wire["payload_bytes"],
                    halo_baseline_bytes=s.halo_baseline_bytes + wire["baseline_bytes"])
                out.append(dataclasses.replace(
                    s, **{k: lanes.product(v) for k, v in made.items()}))
        return out

    return Operation("halo_exchange", fn, phase="pre", collective=True, lane=lane)


def _step_context(ctx: OpContext, ecfg: EngineConfig, state: DistState,
                  neighbors: Optional[NeighborContext]) -> StepContext:
    return StepContext(
        rng=ctx.rng,
        grids=dict(state.grids),
        neighbors=neighbors,
        dt=torch.full((), ecfg.dt, dtype=torch.float32, device=state.pool.device),
        step=ctx.step,
        min_bound=ecfg.min_bound,
        max_bound=ecfg.max_bound,
    )


def dist_env_build_op(dcfg: DomainConfig, ecfg: EngineConfig,
                      from_state_ghost: bool = False) -> Operation:
    """Environment build over the ghost-extended set; queries = local agents
    only.  The halo-extended GridIndex is built once and shared by
    behaviours, forces and the fused cell-list kernel; the dense (C, 27M)
    candidate tensor stays lazy.  ``from_state_ghost`` (the overlapped
    schedule) reads the halo rows from the state's :class:`GhostFrame`
    instead of the exchange's context entry (the same values), runs in the
    exchange lane beside the interior pass, and publishes only what reads
    the ghosts: the index and the neighbours, as the lane's products, set
    into the step context ``interior_env_build`` made."""

    def fn(ctx: OpContext, state: DistState) -> DistState:
        pool = state.pool
        if from_state_ghost:
            gf = state.ghost
            g_pos = torch.cat([pool.position, gf.position])
            g_rad = torch.cat([pool.radius(), gf.radius])
            g_kind = torch.cat([pool.kind, gf.kind])
            g_alive = torch.cat([pool.alive, gf.alive])
        else:
            g_pos, g_rad, g_kind, g_alive = ctx.extras["halo_sources"]
        index = build_index_arrays(ecfg.spec, g_pos, g_alive)
        neighbors = NeighborContext.for_sources(ecfg.spec, index, pool, g_pos, g_rad,
                                                g_kind, g_alive)
        neighbors.masked = ctx.branches is not None and ctx.branches.assuming
        ctx.index = lanes.product(index)
        ctx.neighbors = lanes.product(neighbors)
        if from_state_ghost:
            ctx.sctx = dataclasses.replace(ctx.sctx, neighbors=ctx.neighbors)
        else:
            ctx.pre_positions = pool.position
            ctx.sctx = _step_context(ctx, ecfg, state, ctx.neighbors)
        return state

    return Operation("env_build", fn, phase="pre",
                     lane="exchange" if from_state_ghost else "compute")


# ---------------------------------------------------------------------------
# Interior / boundary-shell split (the overlapped schedule)
# ---------------------------------------------------------------------------


def _interior_cell_tables(dcfg: DomainConfig, spec: GridSpec) -> List[np.ndarray]:
    """Per decomposed dim, a bool table over cell indices: True where the
    cell and both its ±1 neighbours along the dim are ghost-free.  A cell
    can hold ghost rows iff its range reaches outside the owned band
    [0, extent) along some decomposed dim; comparisons lean inclusive."""
    tables = []
    for d in range(dcfg.n_decomposed):
        n = spec.dims[d]
        box = spec.box_size
        lo = spec.origin[d]
        eps = 1e-6 * box
        ghost_capable = np.zeros((n,), bool)
        for i in range(n):
            c_lo = lo + i * box
            c_hi = lo + (i + 1) * box
            ghost_capable[i] = (c_lo < eps) or (c_hi > dcfg.extent - eps)
        tables.append(np.array([not ghost_capable[max(i - 1, 0): i + 2].any()
                                for i in range(n)]))
    return tables


def interior_shell_masks(dcfg: DomainConfig, spec: GridSpec, position: torch.Tensor,
                         alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(interior, shell) row masks over the local pool — an exact partition
    of the live rows, from the cell coordinates the grid build bins by.  The
    cell tables are kept constants (``grid.device_constant``)."""
    coords = cell_coords(spec, position).long()
    ok = torch.ones(position.shape[:1], dtype=torch.bool, device=position.device)
    for d in range(dcfg.n_decomposed):
        table = device_constant(
            ("interior_cells", dcfg, spec, d), position.device,
            lambda d=d: torch.from_numpy(_interior_cell_tables(dcfg, spec)[d]))
        ok = ok & table[coords[:, d]]
    return alive & ok, alive & ~ok


def interior_env_build_op(dcfg: DomainConfig, ecfg: EngineConfig) -> Operation:
    """Local-only environment build of the overlapped schedule (pre op,
    before ``halo_exchange``): a grid index over the live pool alone plus
    the interior/shell row masks, on ``ctx.extras``, and the step context
    and start positions, which read no ghost."""

    def fn(ctx: OpContext, state: DistState) -> DistState:
        pool = state.pool
        index = build_index_arrays(ecfg.spec, pool.position, pool.alive)
        interior, shell = interior_shell_masks(dcfg, ecfg.spec, pool.position, pool.alive)
        ctx.extras["interior_index"] = index
        neighbors = NeighborContext.for_pool(ecfg.spec, index, pool)
        neighbors.masked = ctx.branches is not None and ctx.branches.assuming
        ctx.extras["interior_neighbors"] = neighbors
        ctx.extras["interior_mask"] = interior
        ctx.extras["shell_mask"] = shell
        # What the behaviours read besides the neighbours, made here on the
        # compute lane: the ghost-extended build only sets their neighbours.
        ctx.pre_positions = pool.position
        ctx.sctx = _step_context(ctx, ecfg, state, None)
        return state

    return Operation("interior_env_build", fn, phase="pre")


def interior_forces_op(dcfg: DomainConfig, ecfg: EngineConfig) -> Operation:
    """The interior half of the force op: the same ``mechanical_forces``
    dispatch over the local-only index and sources, row-masked to interior
    rows.  Their 27-boxes hold no ghost-capable cell, so per kept row the
    local cell lists match the ghost-extended ones slot for slot."""

    def fn(ctx: OpContext, state: DistState) -> DistState:
        ctx.extras["interior_force"] = force_pass(
            ecfg, ctx, state, index=ctx.extras["interior_index"],
            neighbors=ctx.extras["interior_neighbors"],
            row_mask=ctx.extras["interior_mask"], scope="interior")
        return state

    return Operation("interior_forces", fn, phase="agent")


def shell_forces_op(dcfg: DomainConfig, ecfg: EngineConfig) -> Operation:
    """The boundary-shell half over the ghost-extended index, merged with
    the interior pass (exactly one pass a row) and applied."""

    def fn(ctx: OpContext, state: DistState) -> DistState:
        shell_force = force_pass(ecfg, ctx, state, row_mask=ctx.extras["shell_mask"],
                                 scope="shell")
        force = torch.where(ctx.extras["interior_mask"][:, None],
                            ctx.extras["interior_force"], shell_force)
        return dataclasses.replace(state, pool=apply_force(state.pool, force, ecfg.dt))

    return Operation("shell_forces", fn, phase="agent")


def dist_boundary_op(dcfg: DomainConfig, ecfg: EngineConfig) -> Operation:
    """§4.4.11 boundary for the decomposed space: non-decomposed dims honour
    ``EngineConfig.boundary`` over [min_bound, max_bound]; decomposed dims
    are left free (the rank torus; migration repartitions them)."""
    nd = dcfg.n_decomposed

    def fn(ctx: OpContext, state: DistState) -> DistState:
        pool = state.pool
        if nd < 3:
            pos = torch.cat([pool.position[:, :nd],
                             apply_boundary(ecfg, pool.position[:, nd:])], dim=1)
            pool = pool.replace(position=pos)
        return dataclasses.replace(state, pool=pool)

    return Operation("boundary", fn, phase="post")


def dist_diffusion_op(dcfg: DomainConfig, ecfg: EngineConfig) -> Operation:
    """Eq 4.3 diffusion with the 1-voxel stencil halo exchange (collective;
    frequency semantics of the single-node op)."""

    def fn(mesh, ctxs, states):
        if not states[0].grids:
            return states
        dt = ecfg.dt * max(ecfg.diffusion_frequency, 1)
        new = {name: distributed_diffuse(dcfg, mesh, [s.grids[name] for s in states], dt,
                                         boundary=ecfg.boundary)
               for name in states[0].grids}
        return [dataclasses.replace(s, grids={k: v[j] for k, v in new.items()})
                for j, s in enumerate(states)]

    return Operation("diffusion", fn, phase="post", frequency=ecfg.diffusion_frequency,
                     gate="cond", collective=True)


def distributed_scheduler(dcfg: DomainConfig, ecfg: EngineConfig) -> Scheduler:
    """The single-node default pipeline with distribution composed as ops:
    ``migrate`` + ``halo_exchange`` after ``sort``; ``env_build`` /
    ``boundary`` / ``diffusion`` replaced by their domain-decomposed
    variants.  With ``overlap_halo``: sort → migrate → interior_env_build →
    halo_exchange → env_build → behaviors → interior_forces → shell_forces
    → …, bit-identical to the serial schedule."""
    sched = Scheduler.default(ecfg)
    sched = sched.insert_after("sort", migrate_op(dcfg))
    overlap = dcfg.overlap_halo and ecfg.force_params is not None
    if overlap:
        sched = sched.insert_after("migrate", interior_env_build_op(dcfg, ecfg))
        sched = sched.insert_after("interior_env_build",
                                   halo_exchange_op(dcfg, lane="exchange"))
        sched = sched.replace_op("forces", interior_forces_op(dcfg, ecfg))
        sched = sched.insert_after("interior_forces", shell_forces_op(dcfg, ecfg))
    else:
        sched = sched.insert_after("migrate", halo_exchange_op(dcfg))
    sched = sched.replace_op("env_build", dist_env_build_op(dcfg, ecfg,
                                                            from_state_ghost=overlap))
    sched = sched.replace_op("boundary", dist_boundary_op(dcfg, ecfg))
    sched = sched.replace_op("diffusion", dist_diffusion_op(dcfg, ecfg))
    return sched


# ---------------------------------------------------------------------------
# The lock-step executor
# ---------------------------------------------------------------------------


def step_ranks(mesh, scheduler: Scheduler, states: Sequence[DistState], step: int,
               branches: Optional[Branches] = None) -> List[DistState]:
    """One iteration of every local rank (``mesh.local_ranks``: all of an
    in-process mesh's, a process mesh's own), op by op in lock-step.
    ``step`` is the ranks' common pre-increment counter, on the host; the
    frequency gates read it.

    Each rank's work runs in its lanes (``core/lanes.py``): its compute
    lane, forked from the caller's current stream, and for an op of
    ``lane="exchange"`` its exchange lane, forked from the compute lane
    (the overlapped schedule's halo exchange and ghost-extended build).  A
    collective op runs each rank's part in that rank's lane; a shift orders
    the receiver's lane after the sender's.  Every lane used is joined back
    into the caller's stream before the step returns.

    Each rank's key is folded with its linear rank index for the step and
    restored after it, as the reference's per-device body does.  A
    collective op takes the lists of every local rank's context and state;
    any other op runs once a local rank.  Nothing of the caller's states is
    changed.

    With ``branches`` (the compiled run, ``core/runner.py``) the ops see
    each rank's device counter as ``OpContext.step``, the key is folded from
    it, and rank r's force passes take their branches under the scope
    ``"rank{r}"`` (setting the j-th slot of a slotted ``diverged``, j its
    local index); an op, or ``fold_rng``, that reads the device while the
    step is captured in a CUDA graph raises ``CaptureError`` naming it."""
    ranks = mesh.local_ranks
    if len(states) != len(ranks):
        raise ValueError(f"step_ranks: {len(states)} states for the local ranks {ranks}")
    keys = [s.rng for s in states]
    with lanes.running(mesh) as run:
        folded, ctxs = [], []
        for j, (r, s) in enumerate(zip(ranks, states)):
            with _on_rank(r):
                s = dataclasses.replace(s, rng=prng.fold_in(s.rng, r))
                counter = step if branches is None else s.step
                with span("op.fold_rng"):
                    rng = scheduler.fold_rng(s, counter)
            folded.append(s)
            ctxs.append(OpContext(
                config=scheduler.config, step=counter, rng=rng,
                branches=None if branches is None else branches.scoped(f"rank{r}", slot=j)))
        states = folded
        for op in scheduler.ordered_ops():
            if op.frequency == 0:
                continue
            fires = step % op.frequency == 0
            if op.gate == "cond" and not fires:
                continue
            run.op = op.name
            run.use(op.lane, states)
            with span(f"op.{op.name}"):
                if op.collective:
                    new = op.fn(mesh, ctxs, states)
                else:
                    new = []
                    for r, ctx, s in zip(ranks, ctxs, states):
                        with _on_rank(r):
                            new.append(op.fn(ctx, s))
            if fires:
                states = new
        run.use("compute")
        out = []
        for r, s, k in zip(ranks, states, keys):
            with _on_rank(r):
                out.append(dataclasses.replace(s, rng=k, step=s.step + 1))
    return [lanes.settled(s) for s in out]


def _host_step(state: DistState) -> int:
    return int(state.step.reshape(-1)[0])


@dataclasses.dataclass(frozen=True)
class DistributedStep:
    """The distributed step over the stacked state (the reference's
    ``jit(shard_map(step))``): ``step(state)`` unstacks, steps every local
    rank once and restacks (on a process mesh: keeps its rank's slice, and
    all-gathers).  :meth:`step_ranks` steps the unstacked ranks."""

    mesh: object
    dcfg: DomainConfig
    config: EngineConfig
    scheduler: Scheduler

    def unstack(self, state: DistState) -> List[DistState]:
        return unstack_state(state, self.mesh)

    def stack(self, states: Sequence[DistState]) -> DistState:
        return stack_states(states, self.mesh.devices[0], mesh=self.mesh)

    def step_ranks(self, states: Sequence[DistState], step: int) -> List[DistState]:
        return step_ranks(self.mesh, self.scheduler, states, step)

    def __call__(self, state: DistState) -> DistState:
        return self.stack(self.step_ranks(self.unstack(state), _host_step(state)))


def jitted_distributed_runner(mesh, dcfg: DomainConfig, ecfg: EngineConfig,
                              scheduler: Optional[Scheduler] = None):
    """A reusable compiled runner for the distributed step (the counterpart
    of the reference's ``jax.jit`` in :func:`make_distributed_step`):
    ``runner(state, n_steps, observables=)`` returns the eager lock-step
    run's ``(final_state, {name: rows})`` bit for bit (``api.
    DistributedSimulation.run``), the step of every rank replayed from CUDA
    graphs keyed by the firing pattern and every rank's branches
    (``core/runner.py``).

    On an in-process mesh every rank must live on one device (one card, or
    the CPU), and one graph holds the step of every rank; a mesh over
    several devices raises ``ValueError`` (ROADMAP item 17).  On a process
    mesh each process replays its own rank's step as CUDA graphs cut at
    every exchange (a gloo exchange cannot be captured: the host stages it
    and waits on the wire), the exchanges run by the host between them; the
    processes agree on chunk lengths and divergences, so every one runs the
    same exchanges in the same order."""
    from .runner import Runner

    mesh = _check_mesh(mesh, dcfg)
    devices = sorted({str(d) for d in mesh.devices})
    if not mesh.process and len(devices) > 1:
        raise ValueError(f"run_jit needs every rank on one device; the mesh spans "
                         f"{devices} (a multi-card distributed run is ROADMAP item 17)")
    return Runner(ecfg, scheduler or distributed_scheduler(dcfg, ecfg), mesh=mesh)


def _check_mesh(mesh, dcfg: DomainConfig):
    """``mesh`` with its ranks numbered in ``dcfg.mesh_axes`` order; raises
    when the axis sizes disagree."""
    mesh = mesh.ordered(dcfg.mesh_axes)
    if tuple(mesh.axis_sizes) != tuple(dcfg.axis_sizes):
        raise ValueError(f"mesh axes {dict(zip(mesh.axis_names, mesh.axis_sizes))} do not "
                         f"match the DomainConfig's axis_sizes {dcfg.axis_sizes}")
    return mesh


def make_distributed_step(mesh, dcfg: DomainConfig, ecfg: EngineConfig,
                          scheduler: Optional[Scheduler] = None) -> DistributedStep:
    """The distributed step over the stacked state representation;
    ``scheduler`` overrides the default distributed schedule (custom ops)."""
    return DistributedStep(mesh=_check_mesh(mesh, dcfg), dcfg=dcfg, config=ecfg,
                           scheduler=scheduler or distributed_scheduler(dcfg, ecfg))


def distributed_step(dcfg: DomainConfig, ecfg: EngineConfig, mesh, state: DistState
                     ) -> DistState:
    """One distributed iteration (the default distributed schedule)."""
    return make_distributed_step(mesh, dcfg, ecfg)(state)


FORCE_OPS = ("forces", "interior_forces", "shell_forces")


def overlap_report(mesh, dcfg: DomainConfig, ecfg: EngineConfig, state: DistState,
                   scheduler: Optional[Scheduler] = None) -> dict:
    """The counterpart of the reference's ``hlo_overlap_report``: one eager
    step of the distributed schedule (``scheduler``, by default
    :func:`distributed_scheduler`'s) from the stacked ``state``,
    and for each force op (``forces``, ``interior_forces``,
    ``shell_forces``) what the lane issuing its pass had waited on when the
    pass issued (``core/lanes.py``): ``passes`` (the reference's
    ``conditionals``), ``collective_ancestors`` (the shifts of every op)
    and ``halo_collective_ancestors`` (those of ``halo_exchange``), at this
    process's first local rank; ``halo_collectives`` counts the step's
    ``halo_exchange`` shifts.  The overlap guarantee: under
    ``overlap_halo`` the interior pass has no halo ancestor (its lane never
    waited on the exchange) and at least one other (migration), the shell
    pass at least one halo ancestor; under the serial schedule ``forces``
    has one.  The records, and so the report, are the same on every
    device."""
    step = make_distributed_step(mesh, dcfg, ecfg, scheduler)
    with lanes.observe() as seen:
        step.step_ranks(step.unstack(state), _host_step(state))
    rank = step.mesh.local_ranks[0]
    report = {"halo_collectives": sum(op == "halo_exchange" for op, _ in seen.shifts)}
    for name in FORCE_OPS:
        records = [rec for r, op, rec in seen.passes if r == rank and op == name]
        ancestors = frozenset().union(*records)
        report[name] = {
            "passes": len(records),
            "collective_ancestors": len(ancestors),
            "halo_collective_ancestors": sum(op == "halo_exchange" for op, _ in ancestors),
        }
    return report


# ---------------------------------------------------------------------------
# Host-side construction and observables
# ---------------------------------------------------------------------------


def init_dist_state(
    dcfg: DomainConfig,
    capacity: int,
    positions: np.ndarray,
    diameter: float | np.ndarray = 10.0,
    kind: Optional[np.ndarray] = None,
    grids: Optional[Dict[str, dgrid.DiffusionGrid]] = None,
    seed: int = 0,
    attrs: Optional[Dict[str, np.ndarray]] = None,
    stacked_grids: Optional[Dict[str, dgrid.DiffusionGrid]] = None,
    device: torch.device | str = "cpu",
) -> DistState:
    """Build the *stacked* state from global agent positions, on ``device``.

    positions are global coordinates in [0, extent·axis_size) per decomposed
    dim; they are binned to ranks and rebased to local frames.
    ``diameter`` and each ``attrs`` array may be scalar or per-agent.
    ``grids`` are replicated to every rank; ``stacked_grids`` (with the
    leading rank axis, e.g. the facade's domain-split substances) are used
    as they are and take precedence."""
    n_dev = dcfg.n_devices
    positions = np.asarray(positions)
    kind = np.zeros((positions.shape[0],), np.int32) if kind is None else np.asarray(kind)
    diam_arr = None if np.ndim(diameter) == 0 else np.asarray(diameter, np.float32)
    attrs = {k: np.asarray(v) for k, v in (attrs or {}).items()}

    dev_coord = []
    local = positions.copy().astype(np.float32)
    for d in range(dcfg.n_decomposed):
        c = np.floor(positions[:, d] / dcfg.extent).astype(np.int64)
        c = np.clip(c, 0, dcfg.axis_sizes[d] - 1)
        dev_coord.append(c)
        local[:, d] = positions[:, d] - c * dcfg.extent

    pools = []
    for dev in range(n_dev):
        coords = dcfg.device_coords(dev)
        sel = np.all([dev_coord[d] == coords[d] for d in range(dcfg.n_decomposed)], axis=0)
        n_here = int(sel.sum())
        if n_here > capacity:
            raise ValueError(f"device {dev} holds {n_here} agents > capacity {capacity}")
        pools.append(make_pool(
            capacity, local[sel],
            diameter=diameter if diam_arr is None else diam_arr[sel],
            kind=kind[sel].astype(np.int32),
            attrs={k: v[sel] for k, v in attrs.items()},
            device=device,
        ))
    pool = tree_map(lambda *xs: torch.stack(xs), *pools)

    stacked = dict(stacked_grids or {})
    for name, g in (grids or {}).items():
        if name not in stacked:
            stacked[name] = replicate(tree_map(lambda x: x.to(device), g), n_dev)
    scale = (dcfg.extent + 2 * dcfg.halo_width) / 32767.0
    codec = HaloCodecState.create(dcfg.n_decomposed, dcfg.halo_capacity, scale, device)
    zeros = torch.zeros((n_dev,), dtype=torch.int32, device=device)
    return DistState(
        pool=pool,
        grids=stacked,
        codec=replicate(codec, n_dev),
        rng=torch.stack([prng.PRNGKey(seed + i, device=device) for i in range(n_dev)]),
        step=zeros,
        migrate_overflow=zeros.clone(),
        halo_overflow=zeros.clone(),
        halo_payload_bytes=zeros.clone(),
        halo_baseline_bytes=zeros.clone(),
        health=replicate(empty_health(device), n_dev),
        ghost=replicate(GhostFrame.create(dcfg, device), n_dev),
    )


def global_kind_counts(state: DistState, n_kinds: Optional[int] = None) -> torch.Tensor:
    """Per-kind alive counts across all ranks (``count_kinds`` flattens the
    rank axis)."""
    return count_kinds(state, n_kinds)


def halo_wire_stats(state: DistState) -> Dict[str, float]:
    """Host-side halo-traffic observable (§6.2.2/§6.2.3): the per-rank
    cumulative counters summed in int64 and the compression ratio
    (baseline / payload; 1.0 before anything was sent).  ``wrapped`` flags
    an i32 counter overflow — call :func:`reset_halo_wire_counters` between
    epochs."""
    both = torch.stack([state.halo_payload_bytes.reshape(-1),
                        state.halo_baseline_bytes.reshape(-1)]).cpu().to(torch.int64)
    payload, baseline = (float(x) for x in both.sum(dim=1))
    return {
        "payload_bytes": payload,
        "baseline_bytes": baseline,
        "compression_ratio": baseline / payload if payload > 0 else 1.0,
        "wrapped": bool((both < 0).any()),
    }


def reset_halo_wire_counters(state: DistState) -> DistState:
    """Zero the cumulative wire counters."""
    zeros = torch.zeros_like(state.halo_payload_bytes)
    return dataclasses.replace(state, halo_payload_bytes=zeros, halo_baseline_bytes=zeros.clone())
