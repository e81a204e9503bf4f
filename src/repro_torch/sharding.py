"""Logical-axis sharding rules → per-device shard shapes (DP / FSDP / TP /
EP / SP), ported from ``repro/sharding.py``.

MaxText-style: every parameter dim carries a logical axis name (see
models/params.py); the table below maps logical names to mesh axes.  A dim
whose size is not divisible by its mesh-axes product silently falls back to
replication (e.g. 8 KV heads on a 16-way tensor axis — the standard GQA
practice of replicating KV over TP).

Mesh: (pod, data, model) multi-pod or (data, model) single-pod.
  batch       → (pod, data)      data parallel across pods and hosts
  embed       → data             FSDP weight shard
  mlp/heads/vocab/experts → model  tensor / expert parallel
  seq (activations)       → model  sequence parallelism between blocks

The reference hands these to XLA's SPMD partitioner as ``NamedSharding``s.
Eager PyTorch has none, so here they are plans: :class:`PartitionSpec` and
:class:`NamedSharding` mirror JAX's (a spec's one-axis tuple is its axis
name, as JAX normalises it), ``NamedSharding.shard_shape`` gives the
per-device block, and :class:`TensorSpec` (shape, dtype, sharding) is the
``ShapeDtypeStruct`` the dry-run plans with.  The rules read only the
mesh's ``shape`` dict (``launch/mesh.Mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

# logical axis name → tuple of mesh axis names (tried in order)
DEFAULT_RULES: dict[str, Tuple[str, ...]] = {
    "embed": ("data",),
    "embed_out": (),
    "mlp": ("model",),
    "mlp_out": (),
    "heads": ("model",),
    "heads_flat": ("model",),
    "kv": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
}


class PartitionSpec(tuple):
    """One entry a leading array dim: ``None`` (replicated), a mesh axis
    name, or a tuple of names; dims past the spec are replicated."""

    def __new__(cls, *parts):
        norm = [p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts]
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The per-device block of an array of ``global_shape``; raises where
        a sharded dim does not divide evenly (as JAX's does)."""
        out = []
        for i, dim in enumerate(global_shape):
            part = self.spec[i] if i < len(self.spec) else None
            n = _mesh_size(self.mesh, (part,) if isinstance(part, str) else part or ())
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} is split {n} ways by "
                                 f"{self.spec}, which does not divide it")
            out.append(dim // n)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape, dtype and (optional) sharding: the port's
    ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)

    @property
    def shard_nbytes(self) -> int:
        """Bytes of one device's block (the whole tensor without a sharding)."""
        shape = self.sharding.shard_shape(self.shape) if self.sharding else self.shape
        return math.prod(shape) * _itemsize(self.dtype)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _mesh_size(mesh, names) -> int:
    return math.prod(mesh.shape[n] for n in names) if names else 1


def _dp(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def tree_map_with_keys(fn: Callable, tree: Any, keys: Tuple[str, ...] = ()) -> Any:
    """``fn(keys, leaf)`` over a tree of dicts and tuples, ``keys`` naming the
    path as JAX's path keys name it for the reference's cache rule: a dict
    key, a named tuple's field name, ``""`` for a plain tuple's index."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, keys + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None)
        items = [tree_map_with_keys(fn, v, keys + (fields[i] if fields else "",))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if fields else tuple(items)
    return fn(keys, tree)


def tree_map2(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over ``tree``'s structure; ``other`` mirrors it
    down to ``tree``'s leaves, where it may hold anything (an axes tuple)."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map2(fn, v, o) for v, o in zip(tree, other)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree, other)


def spec_for_axes(
    mesh,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    rules: Optional[dict] = None,
) -> PartitionSpec:
    """PartitionSpec for one array, honoring divisibility."""
    rules = rules or DEFAULT_RULES
    parts = []
    used: set[str] = set()
    for dim, name in zip(shape, axes):
        if name is None:
            parts.append(None)
            continue
        mesh_axes = tuple(a for a in rules.get(name, ()) if a in mesh.shape and a not in used)
        if mesh_axes and dim % _mesh_size(mesh, mesh_axes) == 0:
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            parts.append(None)
    return P(*parts)


def param_shardings(mesh, param_values, param_axes, rules=None):
    """NamedSharding tree matching the param values tree."""

    def one(v, axes):
        return NamedSharding(mesh, spec_for_axes(mesh, tuple(v.shape), axes, rules))

    return tree_map2(one, param_values, param_axes)


def batch_sharding(mesh, name: str = "batch") -> NamedSharding:
    """Leading-dim batch sharding over all data-parallel axes present."""
    return NamedSharding(mesh, P(_dp(mesh)))


def batch_specs(mesh, batch_shapes) -> Any:
    """Shard every batch input over (pod, data) on its leading dim; scalars
    replicate."""
    dp = _dp(mesh)

    def one(_, s):
        if len(s.shape) == 0 or s.shape[0] % _mesh_size(mesh, dp) != 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(dp))

    return tree_map_with_keys(one, batch_shapes)


def cache_sharding(mesh, shape: Tuple[int, ...], n_kv: int) -> NamedSharding:
    """KV-cache (B, Hkv, S, Dh): batch over (pod, data); heads over model
    when divisible, else *sequence* over model (flash-decoding split-KV) —
    the trick that keeps a 32k GQA cache within per-device HBM."""
    dp = _dp(mesh)
    b, h, s, d = shape
    model = mesh.shape.get("model", 1)
    bspec = dp if b % _mesh_size(mesh, dp) == 0 else None
    if h % model == 0:
        return NamedSharding(mesh, P(bspec, "model", None, None))
    if s % model == 0:
        return NamedSharding(mesh, P(bspec, None, "model", None))
    return NamedSharding(mesh, P(bspec, None, None, None))


def activation_spec(mesh, sequence_parallel: bool = True) -> PartitionSpec:
    """Residual-stream activations (B, T, D): batch over (pod, data); with
    sequence parallelism the sequence dim over model between blocks."""
    dp = _dp(mesh)
    if sequence_parallel and "model" in mesh.shape:
        return P(dp, "model", None)
    return P(dp, None, None)


def cache_shardings(mesh, cache_shapes, n_kv: int) -> Any:
    """Sharding tree for a decode-cache pytree.  Leaves under a ``layers``
    key carry a leading stacked-layer dim (replicated).  KV tensors (4-D
    after the layer dim, under a key holding ``kv``) use ``cache_sharding``'s
    rule; recurrent states (rwkv / rglru) shard batch over (pod, data) and
    their last dim over model when divisible."""
    dp = _dp(mesh)
    model = mesh.shape.get("model", 1)
    dp_size = _mesh_size(mesh, dp)

    def one(keys, s):
        stacked = bool(keys) and keys[0] == "layers"
        shp = tuple(s.shape)
        core = shp[1:] if stacked else shp
        lead = (None,) if stacked else ()
        is_kv = any("kv" in k for k in keys) and len(core) == 4
        if is_kv:
            b, h, seq, d = core
            bspec = dp if b % dp_size == 0 else None
            if h % model == 0:
                parts = (bspec, "model", None, None)
            elif seq % model == 0:
                parts = (bspec, None, "model", None)
            else:
                parts = (bspec, None, None, None)
            return NamedSharding(mesh, P(*lead, *parts))
        parts = []
        for i, dim in enumerate(core):
            if i == 0 and dim % dp_size == 0:
                parts.append(dp)
            elif (
                i == len(core) - 1
                and len(core) >= 2
                and model > 1
                and dim % model == 0
            ):
                parts.append("model")
            else:
                parts.append(None)
        return NamedSharding(mesh, P(*lead, *parts))

    return tree_map_with_keys(one, cache_shapes)
