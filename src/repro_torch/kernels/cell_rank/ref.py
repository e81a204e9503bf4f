"""Plain PyTorch oracle for the within-cell rank primitive.

    rank[i] = |{ j < i : cid[j] == cid[i] }|

O(C²) dense pairwise comparison: the semantic spec, for validation at small
sizes (port of ``repro/kernels/cell_rank/ref.py``).
"""

from __future__ import annotations

import torch


def cell_rank_ref(cid: torch.Tensor) -> torch.Tensor:
    """(C,) int32 within-cell ranks by dense pairwise comparison."""
    c = cid.shape[0]
    idx = torch.arange(c, device=cid.device)
    same = cid[:, None] == cid[None, :]
    earlier = idx[:, None] > idx[None, :]
    return (same & earlier).sum(dim=1, dtype=torch.int32)
