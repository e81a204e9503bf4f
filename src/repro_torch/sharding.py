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
Here :class:`PartitionSpec` and :class:`NamedSharding` mirror JAX's (a
spec's one-axis tuple is its axis name, as JAX normalises it),
``NamedSharding.shard_shape`` gives the per-device block, and
:class:`TensorSpec` (shape, dtype, sharding) is the ``ShapeDtypeStruct``
the dry-run plans with.  The rules read only the mesh's ``shape`` dict
(``launch/mesh.Mesh``).

A sharding becomes DTensor placements on a ``DeviceMesh`` of the same axes
(``launch/mesh.device_mesh``): a tensor dim whose spec entry names mesh
axes is ``Shard(d)`` on each of those mesh dims, every other mesh dim
``Replicate()`` (:func:`placements`).  :func:`distribute_tree` places a
tree on the mesh (meta local shards for a plan, each rank's block of full
tensors for a run), and :class:`Constraint` is the reference's
``with_sharding_constraint``: the models' ``residual_sharding``,
``expert_sharding`` and ``context_sharding`` hooks, which redistribute a
DTensor and pass a plain tensor through.  DTensor then partitions every op
it has a rule for; the kernels' ops, which have none, run on the local
shards under ``local_map`` with the placements their callers state.
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


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: PartitionSpec, mesh_axes: Tuple[str, ...]) -> tuple:
    """DTensor placements of ``spec`` on a mesh whose dims are ``mesh_axes``:
    ``Shard(d)`` on each mesh dim that entry d names, in the spec's order
    (which must be the mesh's: DTensor splits a dim over its mesh dims left
    to right, as JAX over a tuple's axes), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh_axes)
    for d, part in enumerate(spec):
        names = (part,) if isinstance(part, str) else tuple(part or ())
        dims = [mesh_axes.index(n) for n in names]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: dim {d} names mesh axes {names} out of the mesh's "
                             f"order {mesh_axes}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def mesh_dims(dmesh) -> Tuple[list, Optional[int]]:
    """A ``DeviceMesh``'s data-parallel dims (``pod``, ``data``) and its
    ``model`` dim (None without one), as indices."""
    names = tuple(dmesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    return dp, (names.index("model") if "model" in names else None)


def placed(ndim: int, *parts) -> tuple:
    """Placements over ``ndim`` mesh dims: each ``(dims, placement)`` of
    ``parts`` on its mesh dims (a list of indices), ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate

    out = [Replicate()] * ndim
    for dims, placement in parts:
        for i in dims:
            out[i] = placement
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def distribute(t: torch.Tensor, spec: PartitionSpec, dmesh):
    """``t`` as a DTensor of ``spec`` on ``dmesh``: on meta, a meta local
    shard of the block's shape; else this rank's block of ``t``, which every
    rank holds whole (nothing is sent)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, tuple(dmesh.mesh_dim_names))
    if t.device.type != "meta":
        # Each rank's block in storage of its own (not a view of ``t``).
        local = distribute_tensor(t, dmesh, pl, src_data_rank=None).to_local().clone()
        return DTensor.from_local(local, dmesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())
    sizes = dict(zip(dmesh.mesh_dim_names, dmesh.mesh.shape))
    local = NamedSharding(_Axes(sizes), spec).shard_shape(tuple(t.shape))
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), dmesh, pl,
                              run_check=False, shape=t.shape, stride=t.stride())


@dataclasses.dataclass(frozen=True)
class _Axes:
    """A mesh's ``shape`` dict alone, which the sharding rules read."""

    shape: dict


def distribute_tree(tree: Any, specs: Any, dmesh) -> Any:
    """Every tensor of ``tree`` distributed by the matching leaf of
    ``specs`` (a ``TensorSpec`` or ``NamedSharding``, as ``attach_shardings``
    and the ``*_shardings`` rules give them): see :func:`distribute`."""

    def one(t, s):
        sharding = s.sharding if isinstance(s, TensorSpec) else s
        return distribute(t, sharding.spec if sharding else P(), dmesh)

    return tree_map2(one, tree, specs)


@dataclasses.dataclass(frozen=True)
class Constraint:
    """The reference's ``with_sharding_constraint(x, NamedSharding(mesh,
    spec))`` as a hook: a DTensor is redistributed to ``spec``'s placements on
    ``dmesh``, a dim its mesh axes do not divide evenly left whole (as the
    logical-axis rules leave it, ``spec_for_axes``); any other tensor passes
    unchanged."""

    dmesh: Any
    spec: PartitionSpec

    def __call__(self, x):
        if not is_dtensor(x):
            return x
        sizes = dict(zip(self.dmesh.mesh_dim_names, self.dmesh.mesh.shape))
        even = [part if x.shape[d] % _mesh_size(_Axes(sizes), (part,) if isinstance(part, str)
                                                 else part or ()) == 0 else None
                for d, part in enumerate(self.spec)]
        return x.redistribute(self.dmesh, placements(P(*even),
                                                     tuple(self.dmesh.mesh_dim_names)))


def unflattenable(x, dim: int, parts: int):
    """``x`` ready to have dim ``dim`` split into ``(parts, -1)``: a DTensor
    split along it over mesh dims whose sizes do not divide ``parts`` is
    gathered along those first (DTensor cannot unflatten such a split); any
    other tensor passes unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    mesh = x.device_mesh
    pl = list(x.placements)
    n = 1
    for i, p in enumerate(pl):
        if p == Shard(dim):
            if parts % (n * mesh.size(i)):
                pl[i] = Replicate()
            else:
                n *= mesh.size(i)
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(mesh, tuple(pl))


class _OnGrad(torch.autograd.Function):
    """The identity, whose backward applies ``fn`` to the gradient."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def flattened(x, dim: int, parts: int):
    """``x``, a tensor whose dim ``dim`` was flattened from ``(parts, -1)``,
    with its gradient made ``unflattenable`` on the way back (the flatten's
    backward unflattens it); any tensor not a DTensor passes unchanged."""
    if not is_dtensor(x):
        return x
    return _OnGrad.apply(x, lambda g: unflattenable(g, dim, parts))


def grad_placed(x, placements: tuple):
    """``x``, whose gradient is redistributed to ``placements`` on the way
    back (ahead of a view DTensor cannot take in another placement); any
    tensor not a DTensor passes unchanged."""
    if not is_dtensor(x):
        return x
    return _OnGrad.apply(x, lambda g: g.redistribute(g.device_mesh, placements))


class _SumAcross(torch.autograd.Function):
    """Sum all-reduce over a mesh dim whose ranks all go on to use the sum
    alike; so the backward is the identity (Megatron's reduce from the
    tensor-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_across(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a ``(DeviceMesh, dim)``),
    differentiable as :class:`_SumAcross` says."""
    return _SumAcross.apply(t, group)


def max_across(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s elementwise max over the ranks of ``group``, not
    differentiated (a softmax's stabiliser)."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t.detach(), "max", group))


def gather_weights(tree):
    """FSDP's gather as a hook: every DTensor of a parameter tree made whole
    over the data axes (the weight shard of the ``embed`` rule), its other
    placements kept; any other leaf passes unchanged."""
    from torch.distributed.tensor import Replicate

    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    dp, _ = mesh_dims(tree.device_mesh)
    pl = tuple(Replicate() if i in dp else p for i, p in enumerate(tree.placements))
    return tree if pl == tuple(tree.placements) else tree.redistribute(tree.device_mesh, pl)


def split_on(x, dim: int):
    """A DTensor ``x`` whole along every dim but ``dim`` (its splits of the
    others gathered), ahead of a flatten that would otherwise make DTensor
    track a strided split; any other tensor passes unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(p if p == Shard(dim % x.ndim) else Replicate() for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def grad_split_on(x, dim: int):
    """``x``, whose gradient comes back whole along every dim but ``dim``
    (the counterpart of :func:`split_on` for a product's output, whose
    backward flattens its gradient); any tensor not a DTensor passes
    unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    return grad_placed(x, tuple(p if p == Shard(dim % x.ndim) else Replicate()
                                for p in x.placements))


def reduce_partial(x, dim: int):
    """A DTensor ``x``'s pending sums reduced, each onto a split of dim
    ``dim`` (a reduce-scatter), ahead of an op whose rule the card's torch
    lacks for a partial sum (a bias split over the same axis); any other
    tensor passes unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    pl = tuple(Shard(dim % x.ndim) if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def seq_split(x) -> bool:
    """Whether ``x`` is a DTensor split evenly along dim 1 (a sequence)."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard

    ways = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if p == Shard(1))
    return ways > 1 and x.shape[1] % ways == 0


def rows_local(fn: Callable, x, w):
    """``fn(x, w)`` for a product whose output keeps ``x``'s leading two dims
    (batch, sequence), on each rank's rows (``local_map``): ``x`` as it is
    split (any pending sum reduced), ``w`` whole, the output split as ``x``,
    ``w``'s gradient the ranks' partial sums.  The rule of a product over a
    sequence split, where DTensor's would flatten the split dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    x_pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in x_pl):
        raise NotImplementedError(f"rows_local: x placed {x.placements}")
    whole = (Replicate(),) * mesh.ndim
    w_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in x_pl)
    return local_map(fn, out_placements=(x_pl,), in_placements=(x_pl, whole),
                     in_grad_placements=(x_pl, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def constrain(hook: Optional[Constraint], x):
    """``hook(x)``, or ``x`` where there is no hook (the single-device
    paths)."""
    return x if hook is None else hook(x)
