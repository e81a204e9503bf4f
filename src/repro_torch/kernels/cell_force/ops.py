"""Dispatch for the two fused force kernels (Eq 4.1 without the dense
candidate tensor): ``cell_list_force`` straight from the cell list, and
``cell_window_force`` over Morton windows of the layout-sorted pool
(``tile_order="morton"``).

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
from .ref import cell_list_force_ref, cell_window_force_ref

IMPLS = ("cuda", "reference")


def cell_list_force(
    position: torch.Tensor,    # (S, 3) f32 — all indexed agents; (B·S, 3) with slots
    radius: torch.Tensor,      # (S,) f32; (B·S,)
    cell_list: torch.Tensor,   # (n_cells, M) int32, empty slots = S; (B, n_cells, M)
    dims: tuple,               # (nx, ny, nz); n_cells must equal nx·ny·nz
    k: float = 2.0,
    gamma: float = 1.0,
    impl: str = "cuda",
    num_out: int | None = None,
) -> torch.Tensor:
    """Net Eq-4.1 force per agent, ``(num_out, 3)``; rows ``≥ num_out`` of the
    sources contribute to others but receive nothing.  A ``(B, n_cells, M)``
    cell list of within-session ids makes it B sessions at once, each against
    its own S rows: ``(B·num_out, 3)``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown cell_list_force impl {impl!r}; expected {IMPLS}")
    if impl == "cuda" and position.device.type == "meta":
        return _kernel.cell_list_force_meta(position, radius, cell_list, dims, k=k,
                                            gamma=gamma, num_out=num_out)
    if impl == "cuda" and position.device.type != "cpu":
        return _kernel.cell_list_force_cuda(
            position.contiguous(), radius.contiguous(), cell_list.contiguous(),
            dims, k=k, gamma=gamma, num_out=num_out,
        )
    if cell_list.ndim == 3:
        slots = cell_list.shape[0]
        s = position.shape[0] // slots
        return torch.cat([
            cell_list_force_ref(position[b * s:(b + 1) * s], radius[b * s:(b + 1) * s],
                                cell_list[b], dims, k=k, gamma=gamma, num_out=num_out)
            for b in range(slots)])
    return cell_list_force_ref(position, radius, cell_list, dims, k=k,
                               gamma=gamma, num_out=num_out)


def window_defaults(c: int, block: int | None, window: int | None
                    ) -> tuple[int, int]:
    """The Morton window geometry ``(block, half_window)`` for a pool of
    ``c`` rows, a batch's per session (the reference's, copied).

    block:  tile/window width (default 128), halved until it is ≤ c.
    window: half-window in blocks; default ±⌈blocks/8⌉.  A Z-sorted pool's
            neighbours across the curve's octant seams sit about half a pool
            apart, so the default does not cover a sorted pool and the
            coverage gate of ``core.forces`` falls back to the linear kernel;
            ``core.forces.covering_half_window`` gives the least that covers.
    """
    b = 128 if block is None else int(block)
    while b > 1 and b > c:
        b //= 2
    nbw = -(-c // b)
    h = max(1, -(-nbw // 8)) if window is None else int(window)
    return b, h


def negative_ids(cell_of_agent: torch.Tensor) -> torch.Tensor:
    """() bool, on the ids' device: is any cell id below 0?"""
    return (cell_of_agent < 0).any()


def reject_negative_ids(negative: bool) -> None:
    """Raise ``ValueError`` when :func:`negative_ids` said so."""
    if negative:
        raise ValueError("cell_window_force: cell ids must be >= 0 (n_cells and above "
                         "mark dead agents); got a negative id")


def cell_window_force(
    position: torch.Tensor,       # (C, 3) f32 layout-sorted pool positions; (B·C, 3)
    radius: torch.Tensor,         # (C,) f32; (B·C,)
    cell_of_agent: torch.Tensor,  # (C,) int32 linear cell id (dead → n_cells); (B·C,)
    dims: tuple,                  # (nx, ny, nz)
    k: float = 2.0,
    gamma: float = 1.0,
    block: int | None = None,
    window: int | None = None,
    impl: str = "cuda",
    ids_checked: bool = False,
    slots: int | None = None,
) -> torch.Tensor:
    """Net Eq-4.1 force per agent, ``(C, 3)``, via the Morton window: each
    query tile of ``block`` rows against the rows of ``± half_window``
    contiguous blocks, pairs masked by 27-box adjacency of their cell ids.
    Exact iff every agent's neighbourhood lies in its window (the dispatcher
    checks that per step; ``window ≥ ⌈C/block⌉`` is all-pairs).  Dead rows
    get zero.  Agent order in and out: no planar copy.

    ``slots=B``: the flat view of B sessions of C rows each, with cell ids
    within each session's grid; every session against its own rows, the
    window geometry from C (``(B·C, 3)``).

    A negative cell id raises ``ValueError`` on both paths: the reference
    decodes one by floor division into cells beside x = 0, and the kernel
    has no rows for cells that do not exist.  The check reads one flag
    from the card, over every session; ``ids_checked=True`` skips it for a
    caller that has already rejected negative ids (``core.forces`` does, in
    the read its coverage gate makes)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown cell_window_force impl {impl!r}; expected {IMPLS}")
    b = slots or 1
    rows = position.shape[0]
    if rows % b:
        raise ValueError(f"cell_window_force: {rows} rows do not split into {b} slots")
    if not ids_checked:
        reject_negative_ids(bool(negative_ids(cell_of_agent)))
    c = rows // b
    bw, h = window_defaults(c, block, window)
    if impl == "cuda" and position.device.type != "cpu":
        return _kernel.cell_window_force_cuda(
            position.contiguous(), radius.contiguous(),
            cell_of_agent.to(torch.int32).contiguous(), dims, k=k, gamma=gamma,
            block=bw, half_window=h, slots=b,
        )
    if b > 1:
        return torch.cat([
            cell_window_force_ref(position[s * c:(s + 1) * c], radius[s * c:(s + 1) * c],
                                  cell_of_agent[s * c:(s + 1) * c], dims, k=k, gamma=gamma,
                                  block=bw, half_window=h)
            for s in range(b)])
    return cell_window_force_ref(position, radius, cell_of_agent, dims, k=k, gamma=gamma,
                                 block=bw, half_window=h)
