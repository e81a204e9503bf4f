"""Per-step neighbor dataflow: build once, thread everywhere.

Port of ``repro.core.neighbors``.  :class:`NeighborContext` holds the
step's grid index and builds the dense ``(N, 27·M)`` candidate tensor
lazily, at most once per step and only if a consumer asks for it — the
fused cell-list force path never does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .agents import AgentPool
from .grid import GridIndex, GridSpec, candidate_neighbors_arrays


@dataclasses.dataclass
class NeighborContext:
    """One iteration's neighbor state (index + lazily built candidates).

    ``src_*`` tensors are what candidate ids index into (the pool's own
    arrays single-node); ``query_*`` describe the agents queries are
    answered for.  Over the flat view of a batch (``core/slots.py``) the
    index is the batch's and the candidate ids are rows of the flat view,
    each query's within its own session.  In the distributed engine the
    sources are the ghost-extended rows (:meth:`for_sources`).

    ``masked``: the step is being captured for the compiled run
    (``core/runner.py``), so consumers evaluate candidate sets as masked
    dense tiles, never through ``nonzero`` (whose output size is data).
    """

    spec: GridSpec
    index: GridIndex
    src_position: torch.Tensor          # (S, 3)
    src_radius: torch.Tensor            # (S,)
    src_kind: torch.Tensor              # (S,)
    src_alive: torch.Tensor             # (S,)
    query_position: torch.Tensor        # (N, 3) — positions the index was built from
    query_alive: torch.Tensor           # (N,)
    query_ids: Optional[torch.Tensor] = None
    masked: bool = False
    _cand: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False
    )

    @classmethod
    def for_pool(cls, spec: GridSpec, index: GridIndex, pool: AgentPool
                 ) -> "NeighborContext":
        """Single-node case: sources == queries == the pool itself."""
        return cls(
            spec=spec,
            index=index,
            src_position=pool.position,
            src_radius=pool.radius(),
            src_kind=pool.kind,
            src_alive=pool.alive,
            query_position=pool.position,
            query_alive=pool.alive,
        )

    @classmethod
    def for_sources(cls, spec: GridSpec, index: GridIndex, pool: AgentPool,
                    src_position: torch.Tensor, src_radius: torch.Tensor,
                    src_kind: torch.Tensor, src_alive: torch.Tensor
                    ) -> "NeighborContext":
        """Distributed case (§6.2.1): queries are the local pool, sources the
        ghost-extended (local + halo) rows the ``index`` was built over.  The
        first ``pool.capacity`` source rows are the pool itself, so
        ``query_ids`` is a plain arange into the sources."""
        return cls(
            spec=spec,
            index=index,
            src_position=src_position,
            src_radius=src_radius,
            src_kind=src_kind,
            src_alive=src_alive,
            query_position=pool.position,
            query_alive=pool.alive,
            query_ids=torch.arange(pool.capacity, dtype=torch.int32, device=pool.device),
        )

    def candidates(self, cache: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense ``(N, 27M)`` candidate ids + mask, built at most once
        (``cache=False`` builds without keeping the result)."""
        if self._cand is None:
            cand = candidate_neighbors_arrays(
                self.spec, self.index, self.query_position, self.query_alive,
                self.query_ids,
            )
            if not cache:
                return cand
            self._cand = cand
        return self._cand

    def candidates_for(self, ids: torch.Tensor, valid: torch.Tensor):
        """Candidate rows for a subset of queries, ``(A, 27M)``: row r equals
        row ``ids[r]`` of :meth:`candidates`; rows where ``valid`` is False
        come back fully masked."""
        i = ids.long()
        qpos = self.query_position[i]
        qalive = self.query_alive[i] & valid
        qids = ids if self.query_ids is None else self.query_ids[i]
        return candidate_neighbors_arrays(self.spec, self.index, qpos, qalive, qids)

    @property
    def cand(self) -> torch.Tensor:
        return self.candidates()[0]

    @property
    def cand_mask(self) -> torch.Tensor:
        return self.candidates()[1]
