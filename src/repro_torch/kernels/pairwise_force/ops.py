"""Dispatch for the dense pairwise force (``force_impl="cuda"``, the
reference's ``"pallas"``).

  impl="cuda"       the hand-written kernel (kernel.py, csrc/pairwise_force.cu),
                    which gathers the candidates' positions itself; on CPU
                    tensors the plain version.
  impl="reference"  the plain PyTorch version (ref.py).

The reference's wrapper gathers ``(N, K, 3)`` candidate positions and pads
them into a planar layout for TPU BlockSpecs; neither exists here.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import pairwise_force_ref

IMPLS = ("cuda", "reference")


def pairwise_force(
    position: torch.Tensor,    # (N, 3) f32 query agents
    radius: torch.Tensor,      # (N,) f32
    cand: torch.Tensor,        # (N, K) int32 indices into the source arrays
    cand_mask: torch.Tensor,   # (N, K) bool
    k: float = 2.0,
    gamma: float = 1.0,
    impl: str = "cuda",
    all_position: torch.Tensor | None = None,   # (S, 3) candidate sources
    all_radius: torch.Tensor | None = None,     # (S,)
) -> torch.Tensor:
    """Net Eq-4.1 force per query agent, ``(N, 3)``.  ``all_position`` /
    ``all_radius``: the arrays candidate ids index into when they are longer
    than the queries (the distributed engine's ghost-extended sources);
    default: the query arrays."""
    if impl not in IMPLS:
        raise ValueError(f"unknown pairwise_force impl {impl!r}; expected {IMPLS}")
    if impl == "cuda" and position.device.type != "cpu":
        src_pos = position if all_position is None else all_position
        src_rad = radius if all_radius is None else all_radius
        return _kernel.pairwise_force_cuda(
            position.contiguous(), radius.contiguous(), cand.contiguous(),
            cand_mask.contiguous(), k=k, gamma=gamma,
            all_position=src_pos.contiguous(), all_radius=src_rad.contiguous(),
        )
    return pairwise_force_ref(position, radius, cand, cand_mask, k=k, gamma=gamma,
                              all_position=all_position, all_radius=all_radius)
