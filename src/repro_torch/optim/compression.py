"""Delta-encoded, quantized gradient all-reduce over the in-process mesh.

Port of ``repro/optim/compression.py``.  Each rank sends its error-fed
gradient quantized to int8 (or int16) with one scale a tensor, and keeps the
quantization error for the next step:

    q_i = quantize(g_i + e_i),   e_i ← (g_i + e_i) − dequantize(q_i)

The reference runs it under ``shard_map`` with ``psum`` over the data axes;
here the ranks are those of ``launch/mesh.py``'s in-process mesh and a
collective is a function over the list of the ranks' tensors, as in the
distributed engine (``core/distributed.py``).  The combine is the
reference's formula (``compression.py:55-73``), its mean-scale
approximation included: every payload is dequantized with the ranks' mean
scale, not its own, and the error feedback absorbs the difference.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import tree_leaves, tree_leaves_sorted, tree_map

_QMAX = {torch.int8: 127.0, torch.int16: 32767.0}


def init_error_state(grads) -> Any:
    """Per-leaf error-feedback residuals, f32 zeros beside each gradient."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _psum(mesh: Mesh, values: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """``jax.lax.psum(x, axis)`` seen by every rank: the sum, in rank order
    along ``axis``, of the values of the ranks that share the rank's other
    coordinates, on the rank's device."""
    d = mesh.axis_names.index(axis)
    out = []
    for rank in range(mesh.size):
        coords = list(mesh.rank_coords(rank))
        total = None
        for i in range(mesh.axis_sizes[d]):
            coords[d] = i
            x = values[mesh.rank_of(coords)].to(mesh.devices[rank])
            total = x if total is None else total + x
        out.append(total)
    return out


def compressed_psum_leaf(mesh: Mesh, grads: Sequence[torch.Tensor],
                         errs: Sequence[torch.Tensor], axis: str = "data",
                         wire_dtype: torch.dtype = torch.int8
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One leaf over the ranks of ``axis``: ``grads`` and ``errs`` hold one
    tensor a rank; returns each rank's mean gradient and new error."""
    qmax = _QMAX[wire_dtype]
    qs, scales, new_errs = [], [], []
    for g, e in zip(grads, errs):
        x = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / qmax
        q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(wire_dtype)
        new_errs.append(x - q.float() * scale)
        qs.append(q.to(torch.int32))    # int32 sums of ≤ 127 · R stay exact
        scales.append(scale)
    q_sum = _psum(mesh, qs, axis)
    scale_sum = _psum(mesh, scales, axis)          # Σ scales ≈ n · mean scale
    n = float(mesh.shape[axis])
    means = [qsum.float() * (ssum / n) / n for qsum, ssum in zip(q_sum, scale_sum)]
    return means, new_errs


def make_compressed_grad_allreduce(mesh: Mesh, wire_dtype: torch.dtype = torch.int8,
                                   axis_names: Sequence[str] = ("data",)):
    """``fn(grads, errs) → (mean_grads, errs')`` over the ranks: ``grads``
    and ``errs`` hold one tree a rank (nested dicts, leaves matched by key);
    each leaf runs :func:`compressed_psum_leaf` over each of ``axis_names``
    in turn (those the mesh has)."""
    axes = [a for a in axis_names if a in mesh.axis_names]

    def fn(grads: Sequence[Any], errs: Sequence[Any]):
        flat_g = [tree_leaves_sorted(t) for t in grads]
        flat_e = [tree_leaves_sorted(t) for t in errs]
        out_g = [[] for _ in grads]
        out_e = [[] for _ in grads]
        for j in range(len(flat_g[0])):
            g = [f[j] for f in flat_g]
            e = [f[j] for f in flat_e]
            for ax in axes:
                g, e = compressed_psum_leaf(mesh, g, e, ax, wire_dtype)
            for r in range(len(grads)):
                out_g[r].append(g[r])
                out_e[r].append(e[r])
        return ([_rebuild(t, v) for t, v in zip(grads, out_g)],
                [_rebuild(t, v) for t, v in zip(errs, out_e)])

    return fn


def _rebuild(tree, leaves: list):
    """``tree`` with its leaves, in sorted-key order, replaced by ``leaves``."""
    it = iter(leaves)

    def walk(t):
        return {k: walk(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return walk(tree)


def compression_wire_bytes(grads, wire_dtype: torch.dtype = torch.int8) -> Tuple[int, int]:
    """(compressed, baseline-f32) bytes per all-reduce round."""
    n = sum(int(g.numel()) for g in tree_leaves(grads))
    item = torch.empty((), dtype=wire_dtype).element_size()
    return n * item, n * 4
