"""Parameter trees with logical sharding axes, for the port's LM stack.

Port of ``repro/models/params.py``.  Init functions build nested dicts whose
leaves are :class:`Param`: a tensor plus a tuple of *logical axis names*, one
a dim, the reference's names at the reference's lines.  ``unzip`` splits the
tree into (values, axes); ``repro_torch.sharding`` maps logical names to mesh
axes for the dry-run.  ``Model.init`` returns the value tree, with the
reference's structure key for key, so a reference tree converts by copying
(``repro_torch.convert.lm_params_from_numpy``); ``Model.init_params`` returns
the ``Param`` tree.  The tree helpers below walk dicts and tuples (the decode
caches hold ``(prev_x, S)`` pairs and ``RGLRUState`` named tuples); a
``Param`` is a leaf to them.

Draws come from an explicit ``torch.Generator`` on the device the values are
made on.  The generator's stream differs from ``jax.random``'s, so parity
tests carry the reference's values across instead of re-drawing them.  A
generator cannot live on the meta device: there :data:`SHAPE_ONLY` stands in
for it, and ``normal``, ``zeros`` and ``ones`` make the shape and nothing
else (no storage, no draw).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

# Logical axis vocabulary (see repro_torch/sharding.py for the mesh mapping):
#   "embed"   — d_model dims
#   "mlp"     — d_ff dims
#   "heads"   — attention head count dims (q)
#   "kv"      — kv head count dims
#   "head_dim"— per-head feature dim
#   "vocab"   — vocabulary dim
#   "experts" — MoE expert dim
#   "layers"  — stacked layer dim
#   None      — replicated


@dataclasses.dataclass
class Param:
    value: Any                           # torch.Tensor (a meta tensor in the dry-run)
    axes: Tuple[Optional[str], ...]


def is_param(x: Any) -> bool:
    return isinstance(x, Param)


class ShapeOnly:
    """The meta device's stand-in for a ``torch.Generator``: it has a
    ``device`` and draws nothing."""

    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def randn(gen, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` on its device (the shape alone
    on meta)."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)


def normal(gen, shape: Sequence[int], scale: float, dtype: torch.dtype,
           axes: Tuple[Optional[str], ...]) -> Param:
    """N(0, std²) with the reference's rule ``std = scale / sqrt(shape[0])``
    (``params.py:42-45``): the fan-in is the first axis whatever the shape,
    so ``wo (H, Dh, D)`` has fan-in H (ROADMAP §3)."""
    if gen.device.type == "meta":
        return Param(torch.empty(tuple(shape), dtype=dtype, device="meta"), axes)
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / max(fan_in, 1) ** 0.5
    return Param((randn(gen, shape) * std).to(dtype), axes)


def zeros(shape: Sequence[int], dtype: torch.dtype, device,
          axes: Tuple[Optional[str], ...]) -> Param:
    if torch.device(device).type == "meta":
        return Param(torch.empty(tuple(shape), dtype=dtype, device="meta"), axes)
    return Param(torch.zeros(tuple(shape), dtype=dtype, device=device), axes)


def ones(shape: Sequence[int], dtype: torch.dtype, device,
         axes: Tuple[Optional[str], ...]) -> Param:
    if torch.device(device).type == "meta":
        return Param(torch.empty(tuple(shape), dtype=dtype, device="meta"), axes)
    return Param(torch.ones(tuple(shape), dtype=dtype, device=device), axes)


def const(value: torch.Tensor, axes: Tuple[Optional[str], ...]) -> Param:
    return Param(value, axes)


def unzip(tree: Any) -> Tuple[Any, Any]:
    """Split a Param tree into (values, axes) trees of identical structure."""
    return tree_map(lambda p: p.value, tree), tree_map(lambda p: p.axes, tree)


def _stacked(leaf: Any, n: int) -> Any:
    """An empty stack of ``n`` copies of ``leaf``; a ``Param`` stack carries
    the axes ``("layers",) + axes`` (the reference's ``stack_params``)."""
    if is_param(leaf):
        return Param(leaf.value.new_empty((n, *leaf.value.shape)), ("layers",) + leaf.axes)
    return leaf.new_empty((n, *leaf.shape))


def _value(leaf: Any) -> torch.Tensor:
    return leaf.value if is_param(leaf) else leaf


def stack_layers(make: Callable[[], Any], n: int) -> Any:
    """Stack ``n`` per-layer trees (of tensors or of ``Param``s), made one at
    a time by ``make()``, along a new leading layer axis.  Each tree is
    copied into the stack as soon as it is made, so besides the stack only
    one layer's tree is alive: at full width a list of per-layer trees
    stacked at the end would hold the layer weights twice."""
    first = make()
    stacked = tree_map(lambda t: _stacked(t, n), first)

    def put(g, tree):
        for dst, src in zip(tree_leaves(stacked), tree_leaves(tree)):
            _value(dst)[g] = _value(src)

    put(0, first)
    del first
    for g in range(1, n):
        put(g, make())
    return stacked


def unstack(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of a tree stacked along a leading layer axis,
    by one ``unbind`` a leaf.  Its views' gradients are stacked once by
    ``unbind``'s backward, where indexing layer by layer (``a[g]``) would
    write each layer's gradient into a zero tensor of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [unstack(v, n) for v in tree]
        make = (lambda items: type(tree)(*items)) if hasattr(tree, "_fields") else tuple
        return [make([p[i] for p in parts]) for i in range(n)]
    return list(tree.unbind(0))


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_sorted(tree: Any) -> list:
    """Leaves with each dict's keys in sorted order (``jax.tree.leaves``'s
    order), so that a walk does not depend on insertion order: a restored
    checkpoint's dicts come back sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_sorted(tree[k])]
    return tree_leaves(tree)


def tree_size(values: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(values))
