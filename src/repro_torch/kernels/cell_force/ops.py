"""Dispatch for the fused cell-list force (Eq 4.1 straight from the cell list).

Semantics match the dense candidate path when no cell overflowed: the pair
set is "all agents in the 27-box neighborhood, minus self".  Agents dropped
from an overflowing cell are invisible here — they exert no force and
receive none — so ``core.forces.mechanical_forces`` falls back to the dense
path when ``index.overflowed``.

  impl="cuda"       the hand-written kernel (kernel.py,
                    csrc/cell_list_force.cu); on CPU tensors the plain
                    version.
  impl="reference"  the plain PyTorch version (ref.py).
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from .ref import cell_list_force_ref

IMPLS = ("cuda", "reference")


def cell_list_force(
    position: torch.Tensor,    # (S, 3) f32 — all indexed agents
    radius: torch.Tensor,      # (S,) f32
    cell_list: torch.Tensor,   # (n_cells, M) int32, empty slots = S
    dims: tuple,               # (nx, ny, nz); n_cells must equal nx·ny·nz
    k: float = 2.0,
    gamma: float = 1.0,
    impl: str = "cuda",
    num_out: int | None = None,
) -> torch.Tensor:
    """Net Eq-4.1 force per agent, ``(num_out, 3)``; rows ``≥ num_out`` of the
    sources contribute to others but receive nothing."""
    if impl not in IMPLS:
        raise ValueError(f"unknown cell_list_force impl {impl!r}; expected {IMPLS}")
    if impl == "cuda" and position.device.type != "cpu":
        return _kernel.cell_list_force_cuda(
            position.contiguous(), radius.contiguous(), cell_list.contiguous(),
            dims, k=k, gamma=gamma, num_out=num_out,
        )
    return cell_list_force_ref(position, radius, cell_list, dims, k=k,
                               gamma=gamma, num_out=num_out)


def cell_window_force(*args, **kwargs):
    """The Morton-window force (``tile_order="morton"``) is not ported yet."""
    raise NotImplementedError(
        "cell_window_force (tile_order='morton') is not ported yet: "
        "ROADMAP queue 2 item 4"
    )
