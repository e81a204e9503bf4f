"""The slot axis of a batch of independent sessions.

``core/batch.py`` stores B sessions as one ``SimulationState`` whose every
leaf carries a leading slot axis (the *slots layout*): slot ``b``'s session
is ``tree_map(lambda l: l[b], states)``.  The batched step works on the
*flat view* of that storage, where the pool's per-agent leaves are B·C rows
(slot ``b`` owns rows ``b·C .. b·C + C − 1``) and every other leaf keeps its
slot axis.  Per-agent ops run on the rows; per-slot work (counters,
reductions, compaction, health) reshapes them to ``(B, C)``.

The engine's primitives recognise a flat view by its shapes, so the built-in
behaviours run on it unchanged:

  * ``AgentPool.overflow`` is ``(B,)`` (a solo pool's is ``()``);
  * ``DiffusionGrid.concentration`` is ``(B, nx, ny, nz)``;
  * ``GridIndex.cell_list`` is ``(B, n_cells, M)`` of within-slot ids;
  * a key batch is ``(B, 2)`` (``core/prng.py``).

Reshapes between the two layouts are views: no data moves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable[..., Any], *trees):
    """Map ``fn`` over the tensor leaves of equally shaped trees of
    dataclasses, dicts and tensors; ``None`` stays ``None`` and fields marked
    ``metadata={"static": True}`` keep the first tree's value."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)
            if f.init and not f.metadata.get("static", False)
        })
    return fn(*trees)


def _map_rows(pool, fn):
    """``pool`` with ``fn`` applied to every per-agent leaf (all but
    ``overflow``, which holds one value a slot)."""
    return pool.replace(
        position=fn(pool.position), diameter=fn(pool.diameter), kind=fn(pool.kind),
        age=fn(pool.age), alive=fn(pool.alive), static=fn(pool.static),
        attrs={k: fn(v) for k, v in pool.attrs.items()},
    )


def to_flat(state):
    """The flat view of a slots-layout state: per-agent leaves ``(B·C, ...)``."""
    pool = _map_rows(state.pool, lambda x: x.reshape((-1,) + tuple(x.shape[2:])))
    return dataclasses.replace(state, pool=pool)


def to_slots(state):
    """The slots layout of a flat view: per-agent leaves ``(B, C, ...)``."""
    b = state.pool.overflow.shape[0]
    pool = _map_rows(state.pool, lambda x: x.reshape((b, -1) + tuple(x.shape[1:])))
    return dataclasses.replace(state, pool=pool)


def slot_of(state, b: int):
    """Slot ``b`` of a slots-layout state, as a solo state of views."""
    return tree_map(lambda leaf: leaf[b], state)


def select(live: torch.Tensor, new, old):
    """Per slot, ``new`` where ``live`` (a ``(B,)`` bool tensor) and ``old``
    elsewhere, leaf by leaf, over slots-layout trees."""

    def pick(n, o):
        keep = live.reshape((-1,) + (1,) * (n.ndim - 1))
        if n.dtype == torch.uint32:
            # CUDA's where has no uint32 kernel: select the key's bits as int32.
            return torch.where(keep, n.view(torch.int32), o.view(torch.int32)).view(n.dtype)
        return torch.where(keep, n, o)

    return tree_map(pick, new, old)


def row_slot(rows: int, slots: int, device) -> torch.Tensor:
    """(rows,) int64: the slot that owns each row of a flat view."""
    per = rows // slots
    return torch.arange(rows, device=device) // per
