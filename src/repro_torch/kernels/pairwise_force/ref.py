"""Plain PyTorch version of the dense pairwise force (Eq 4.1).

Port of ``repro/kernels/pairwise_force/ref.py`` with the Pallas kernel's
pair arithmetic (``kernel.py:65-74``): each query against its gathered
``(N, K)`` candidates, masked, summed over K.
"""

from __future__ import annotations

import torch


def pairwise_force_ref(
    position: torch.Tensor,    # (N, 3) f32 query agents
    radius: torch.Tensor,      # (N,) f32
    cand: torch.Tensor,        # (N, K) int32 ids into the sources
    cand_mask: torch.Tensor,   # (N, K) bool
    k: float = 2.0,
    gamma: float = 1.0,
    all_position: torch.Tensor | None = None,   # (S, 3) sources (default: queries)
    all_radius: torch.Tensor | None = None,     # (S,)
) -> torch.Tensor:
    """Net force per query agent, ``(N, 3)``:
    Σ_j [k·δ − γ√(r̄δ)]⁺ · (x_i − x_j)/|x_i − x_j| over the masked candidates."""
    src_pos = position if all_position is None else all_position
    src_rad = radius if all_radius is None else all_radius
    # A masked-out slot's offset is zero whatever row it read, so a batch's
    # flat candidates never read another session; a pair adds only where it
    # overlaps, so a non-finite candidate (its offset NaN) adds nothing, as
    # in the kernel.
    safe = torch.where(cand_mask, cand, 0).long()
    cpos = src_pos[safe]                                    # (N, K, 3)
    crad = src_rad[safe]                                    # (N, K)
    dx = torch.where(cand_mask, position[:, None, 0] - cpos[..., 0], 0.0)
    dy = torch.where(cand_mask, position[:, None, 1] - cpos[..., 1], 0.0)
    dz = torch.where(cand_mask, position[:, None, 2] - cpos[..., 2], 0.0)
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-20)
    r = radius[:, None]
    delta = r + crad - dist
    overlap = (delta > 0.0) & cand_mask
    rbar = r * crad / torch.clamp(r + crad, min=1e-20)
    mag = k * delta - gamma * torch.sqrt(torch.clamp(rbar * delta, min=0.0))
    scale = torch.where(overlap, mag / dist, 0.0)
    return torch.stack([torch.where(overlap, scale * d, 0.0).sum(1) for d in (dx, dy, dz)],
                       dim=-1)
