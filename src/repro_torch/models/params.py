"""Parameter initialisation for the port's LM stack.

The reference builds trees of ``Param`` (a value plus logical sharding
axes) and splits them with ``unzip``.  The port keeps only the value tree,
with the reference's structure key for key, so a reference tree converts by
copying (``repro_torch.convert.lm_params_from_numpy``).  Logical axes wait
for sharding (ROADMAP queue 1, item 15.6).  The tree helpers below walk dicts
and tuples (the decode caches hold ``(prev_x, S)`` pairs and
``RGLRUState`` named tuples).

Draws come from an explicit ``torch.Generator`` on the device the values are
made on.  The generator's stream differs from ``jax.random``'s, so parity
tests carry the reference's values across instead of re-drawing them.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def normal(gen: torch.Generator, shape: Sequence[int], scale: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, std²) with the reference's rule ``std = scale / sqrt(shape[0])``
    (``params.py:42-45``): the fan-in is the first axis whatever the shape,
    so ``wo (H, Dh, D)`` has fan-in H (ROADMAP §3)."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / max(fan_in, 1) ** 0.5
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return (x * std).to(dtype)


def zeros(shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def stack_layers(make: Callable[[], Any], n: int) -> Any:
    """Stack ``n`` per-layer trees, made one at a time by ``make()``, along a
    new leading layer axis.  Each tree is copied into the stack as soon as it
    is made, so besides the stack only one layer's tree is alive: at full
    width a list of per-layer trees stacked at the end would hold the layer
    weights twice."""
    first = make()
    stacked = tree_map(lambda t: t.new_empty((n, *t.shape)), first)

    def put(g, tree):
        for dst, src in zip(tree_leaves(stacked), tree_leaves(tree)):
            dst[g] = src

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
