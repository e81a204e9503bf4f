"""Agent pools: the SoA agent state of the simulation (§4.2, §5.3.2).

Port of ``repro.core.agents``: one fixed-capacity tensor per attribute plus
an ``alive`` mask.  Dtypes follow the reference (f32 floats, i32 ids and
kinds, bool masks); indices are cast to int64 only where torch indexes.
Births and deaths are the §5.3.2 parallel add / remove: prefix-sum ranks and
one scatter, no sort.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

# Dtype canonicalization of the reference (JAX with 64-bit types disabled):
# host doubles become f32 and host 64-bit ints become i32.
_CANONICAL = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
}


def as_tensor(value: Any, device: torch.device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """``value`` (python scalar, numpy array or tensor) as a tensor on
    ``device`` with the reference's canonical dtype (or ``dtype``)."""
    t = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
    if dtype is None:
        dtype = _CANONICAL.get(t.dtype, t.dtype)
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class AgentPool:
    """Fixed-capacity structure-of-arrays agent container.

    position (C, 3) f32, diameter (C,) f32, kind (C,) i32, age (C,) f32,
    alive (C,) bool, static (C,) bool (§5.5 static-agent flag), attrs
    {name: (C, ...)}, overflow () i32 — agents dropped for lack of capacity.
    """

    position: torch.Tensor
    diameter: torch.Tensor
    kind: torch.Tensor
    age: torch.Tensor
    alive: torch.Tensor
    static: torch.Tensor
    attrs: Dict[str, torch.Tensor]
    overflow: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def slots(self) -> int | None:
        """B for the flat view of a batch of B sessions (``core/slots.py``:
        ``overflow`` is (B,), the rows are B blocks of C), None solo."""
        return self.overflow.shape[0] if self.overflow.ndim else None

    def per_slot(self, x: torch.Tensor) -> torch.Tensor:
        """Per-agent ``x`` as ``(slots, C, ...)`` (``(1, C, ...)`` solo)."""
        return x.reshape((self.slots or 1, -1) + tuple(x.shape[1:]))

    def slot_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-agent ``x`` summed within each slot, int32: (B,), () solo."""
        return self.per_slot(x).sum(dim=1, dtype=torch.int32).reshape(self.overflow.shape)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def replace(self, **kw: Any) -> "AgentPool":
        return dataclasses.replace(self, **kw)

    def radius(self) -> torch.Tensor:
        return 0.5 * self.diameter

    def get(self, name: str) -> torch.Tensor:
        return self.attrs[name]

    def set_attr(self, name: str, value: torch.Tensor) -> "AgentPool":
        attrs = dict(self.attrs)
        attrs[name] = value
        return self.replace(attrs=attrs)


def _pad_rows(x: torch.Tensor, capacity: int) -> torch.Tensor:
    out = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def make_pool(
    capacity: int,
    position,
    diameter=10.0,
    kind=0,
    attrs: Mapping[str, Any] | None = None,
    attr_defaults: Mapping[str, Any] | None = None,
    device: torch.device | str = "cpu",
) -> AgentPool:
    """Create a pool with the first ``n = len(position)`` slots alive.

    ``attrs`` supplies per-agent initial values of shape (n, ...), each
    padded to capacity with zeros; ``attr_defaults`` declares attribute
    names/dtypes that start at zero for all agents.
    """
    device = torch.device(device)
    position = as_tensor(position, device, torch.float32)
    n = position.shape[0]
    if n > capacity:
        raise ValueError(f"initial population {n} exceeds capacity {capacity}")
    live = torch.arange(capacity, device=device) < n

    pos = _pad_rows(position, capacity)
    diam_t = as_tensor(diameter, device, torch.float32)
    if diam_t.ndim == 0:
        diam = torch.where(live, diam_t, torch.zeros((), device=device))
    else:
        diam = _pad_rows(diam_t, capacity)
    kind_t = as_tensor(kind, device, torch.int32)
    if kind_t.ndim == 0:
        knd = torch.full((capacity,), int(kind_t), dtype=torch.int32, device=device)
    else:
        knd = _pad_rows(kind_t, capacity)

    full_attrs: Dict[str, torch.Tensor] = {}
    for name, val in (attrs or {}).items():
        val = as_tensor(val, device)
        if val.shape[0] != n:
            raise ValueError(
                f"attr {name!r} has {val.shape[0]} rows, expected one per "
                f"initial agent ({n}); it is padded to capacity here"
            )
        full_attrs[name] = _pad_rows(val, capacity)
    for name, proto in (attr_defaults or {}).items():
        if name in full_attrs:
            continue
        p = as_tensor(proto, device)
        full_attrs[name] = torch.zeros((capacity,) + tuple(p.shape), dtype=p.dtype,
                                       device=device)

    return AgentPool(
        position=pos,
        diameter=diam,
        kind=knd,
        age=torch.zeros((capacity,), dtype=torch.float32, device=device),
        alive=live,
        static=torch.zeros((capacity,), dtype=torch.bool, device=device),
        attrs=full_attrs,
        overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Attribute schema validation (the typed SoA attr surface of the model API).
# ---------------------------------------------------------------------------

def canonicalize_attr(name: str, value: Any, n: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Validate/broadcast one per-agent attribute to ``n`` leading rows.

    Scalars broadcast to ``(n,)`` (python floats → f32, ints → i32, bools →
    bool); arrays must already carry ``n`` rows.
    """
    arr = as_tensor(value, torch.device(device))
    if arr.ndim == 0:
        return arr.expand(n).clone()
    if arr.shape[0] != n:
        raise ValueError(
            f"attr {name!r}: leading dim {arr.shape[0]} != {n} agents in this "
            f"group (per-agent attrs need one row per agent; scalars broadcast)"
        )
    return arr


def attr_signature(arr: torch.Tensor) -> tuple:
    """The schema key of one attribute array: (trailing shape, dtype)."""
    return (tuple(arr.shape[1:]), arr.dtype)


def check_attr_schema(name: str, arr: torch.Tensor, schema: Mapping[str, tuple]) -> None:
    """Assert ``arr`` matches the (trailing-shape, dtype) signature already
    registered for ``name``; raises with both signatures spelled out."""
    want = schema[name]
    got = attr_signature(arr)
    if got != want:
        raise TypeError(
            f"attr {name!r}: group declares trailing shape {got[0]} dtype "
            f"{got[1]}, but an earlier group declared {want[0]} {want[1]} — "
            f"all agent groups must share one SoA schema"
        )


# ---------------------------------------------------------------------------
# Sort-free compaction (§5.3.2).
# ---------------------------------------------------------------------------

def compact_indices(mask: torch.Tensor, capacity: int, fill: int = 0):
    """Indices of set bits in ascending order, by prefix sum + scatter.

    Returns ``(ids, valid, n)``: ``ids (capacity,) i32`` holds the r-th set
    index at rank r (``fill`` beyond), ``valid (capacity,) bool`` marks the
    occupied ranks, ``n ()`` i32 is the set-bit count (may exceed capacity).
    A ``(B, m)`` mask compacts each row on its own: ``(B, capacity)``,
    ``(B, capacity)``, ``(B,)``.
    """
    m = mask.shape[-1]
    dev = mask.device
    mi = mask.to(torch.int32)
    n = mi.sum(dim=-1, dtype=torch.int32)
    rank = torch.cumsum(mi, -1, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < capacity), rank, capacity)
    # One spare slot takes every dropped write (the reference's mode="drop").
    ids = torch.full(mask.shape[:-1] + (capacity + 1,), fill, dtype=torch.int32, device=dev)
    ids.scatter_(-1, slot.long(), torch.arange(m, dtype=torch.int32, device=dev).expand_as(slot))
    valid = torch.arange(capacity, device=dev) < torch.clamp(n, max=capacity)[..., None]
    return ids[..., :capacity], valid, n


def free_slot_table(alive: torch.Tensor) -> torch.Tensor:
    """``table[r]`` = index of the r-th free (dead) slot, capacity where none
    (row by row for a ``(B, C)`` mask)."""
    c = alive.shape[-1]
    ids, _, _ = compact_indices(~alive, c, fill=c)
    return ids


def remove_agents(pool: AgentPool, remove_mask: torch.Tensor) -> AgentPool:
    """Remove agents by mask (clear ``alive``; no data moves)."""
    return pool.replace(alive=pool.alive & ~remove_mask)


def add_agents(
    pool: AgentPool,
    spawn_mask: torch.Tensor,
    position: torch.Tensor,
    diameter: torch.Tensor,
    kind: torch.Tensor,
    attrs: Mapping[str, torch.Tensor] | None = None,
    age: torch.Tensor | None = None,
) -> AgentPool:
    """Commit spawn requests into free slots (deterministic, parallel).

    ``spawn_mask`` (C,) marks live spawners; the value arrays are aligned
    with it (row i describes the child of agent i).  The k-th spawn in index
    order takes the k-th free slot; spawns beyond the free slots are dropped
    and counted in ``overflow``.  Attrs not given are inherited from the
    spawner, ``age`` defaults to 0 and ``static`` is cleared.  On the flat
    view of a batch the ranks, free slots and overflow are each slot's own,
    so births land in the rows a solo run of the slot gives them.
    """
    spawn_mask = spawn_mask & pool.alive
    rows = pool.capacity
    spawn = pool.per_slot(spawn_mask)                                   # (B, C)
    alive = pool.per_slot(pool.alive)
    b, c = spawn.shape
    spawn_rank = torch.cumsum(spawn.to(torch.int32), 1, dtype=torch.int32) - 1
    n_free = (~alive).sum(dim=1, dtype=torch.int32)
    n_spawn = spawn.sum(dim=1, dtype=torch.int32)
    free_slots = free_slot_table(alive)
    fits = spawn & (spawn_rank < n_free[:, None])
    # Row ``rows`` is the reference's mode="drop": a spare row, cut off below.
    local = free_slots.gather(1, torch.clamp(spawn_rank, 0, c - 1).long())
    if b > 1:
        local = local + torch.arange(0, rows, c, dtype=torch.int32, device=pool.device)[:, None]
    target = torch.where(fits, local, rows).reshape(-1).long()

    def put(dst: torch.Tensor, src) -> torch.Tensor:
        if isinstance(src, (bool, int, float)):   # a fill, not a host-to-device copy
            src = torch.full((), src, dtype=dst.dtype, device=dst.device)
        else:
            src = torch.as_tensor(src, dtype=dst.dtype, device=dst.device)
        out = torch.cat([dst, dst[:1]], dim=0)
        out[target] = src.expand_as(dst)
        return out[:rows]

    age_src = torch.zeros((rows,), dtype=torch.float32, device=pool.device) if age is None else age
    attrs = dict(attrs or {})
    dropped = torch.clamp(n_spawn - n_free, min=0).reshape(pool.overflow.shape)
    return pool.replace(
        position=put(pool.position, position),
        diameter=put(pool.diameter, diameter),
        kind=put(pool.kind, kind),
        age=put(pool.age, age_src),
        alive=put(pool.alive, True),
        static=put(pool.static, False),
        attrs={name: put(arr, attrs.get(name, arr)) for name, arr in pool.attrs.items()},
        overflow=pool.overflow + dropped,
    )


def permute(pool: AgentPool, perm: torch.Tensor) -> AgentPool:
    """Reorder all agent attributes by ``perm`` (gather form)."""
    p = perm.long()
    take = lambda x: x.index_select(0, p)
    return pool.replace(
        position=take(pool.position),
        diameter=take(pool.diameter),
        kind=take(pool.kind),
        age=take(pool.age),
        alive=take(pool.alive),
        static=take(pool.static),
        attrs={k: take(v) for k, v in pool.attrs.items()},
    )


def permute_to(pool: AgentPool, dest: torch.Tensor) -> AgentPool:
    """Scatter agent ``i`` to slot ``dest[i]`` (``dest`` must be a
    permutation) — ``permute(pool, argsort(dest))`` without the argsort."""
    d = dest.long()

    def scat(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(x)
        out[d] = x
        return out

    return pool.replace(
        position=scat(pool.position),
        diameter=scat(pool.diameter),
        kind=scat(pool.kind),
        age=scat(pool.age),
        alive=scat(pool.alive),
        static=scat(pool.static),
        attrs={k: scat(v) for k, v in pool.attrs.items()},
    )


def compact(pool: AgentPool) -> AgentPool:
    """Move alive agents to the front, stably (restores density after
    removal)."""
    perm = torch.sort((~pool.alive).to(torch.int32), stable=True).indices
    return permute(pool, perm)
