"""Dry-run of the port: every (architecture × input shape × mesh) cell
planned on the meta device, with no card and no storage.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell against ``ShapeDtypeStruct``s on 512 fake host devices and reads XLA's
``memory_analysis``, ``cost_analysis`` and the collectives of its HLO.  Here,
for every cell:

    plan  = lower_cell(arch, shape, mesh)   # the step's arguments as sharded
                                            # TensorSpecs (repro_torch.sharding)
    costs = one device's program of the step on meta tensors, under
            FlopCounterMode and a dispatch mode that counts bytes, live
            storage and collectives

On a one-device mesh the step runs as it is.  On a mesh of more devices the
LM cells run **partitioned** (``partition``): the process is rank 0 of a
``"fake"`` process group of the mesh's size (``launch/mesh.fake_group``), the
arguments are DTensors of their shardings on a ``DeviceMesh`` of the mesh's
axes (meta local shards), and DTensor partitions the step; the kernels' ops,
the loss, attention, the sequence-split products, the MoE layer's expert
parallelism, rwkv6's heads and the RG-LRU's recurrence in a train step
run under explicit ``local_map`` rules, and the reference's sharding
constraints are the model's hooks (``residual_sharding``,
``expert_sharding``, ``context_sharding``; ``models/model.py``).  The counters see rank 0's
local ops and its ``_c10d_functional`` collectives.  TeraAgent's cell steps
every rank of the lock-step engine (``distributed.step_ranks``) on meta, its
force passes taking the branches an eager CPU step records, with a mesh of
the production mesh's axes at 2 ranks an axis (a rank's work and bytes do
not depend on the axis sizes); each rank's work is counted under its
``distributed.rank_scope``, and rank 0's is the device's.

The JSON record has the reference's fields and units:

  flops_per_device           ``torch.utils.flop_counter.FlopCounterMode``
                             over rank 0's ops.  With ``attention_impl=
                             "cuda"`` the flash kernel is not an aten op: each
                             call adds ``flash_attention_flops`` (4 · D FLOPs
                             for every (query, key) pair of each 64 × 64 tile
                             that holds a visible pair, as ``chip_smoke.py``
                             bounds the kernel); with ``"chunked"`` (the
                             configs' default) the counter sees the plain
                             version's products.  TeraAgent's step has few
                             products, and the counter counts nothing else.
  bytes_accessed_per_device  every aten op's operand and result bytes, as
                             XLA:CPU's ``bytes accessed`` counts them; view
                             ops move nothing and allocations write nothing,
                             so neither counts, and a kernel's stand-in
                             counts only its outputs' allocation (nothing).
  collective_bytes_per_device  the operand bytes of rank 0's collectives by
                             the reference's five kinds and ``total``, as
                             ``collective_bytes_from_hlo`` counts them:
                             DTensor's ``_c10d_functional`` ops, and the
                             bytes a TeraAgent rank sends through
                             ``Mesh.shift`` (``collective-permute``); the
                             CLI prints them by kind and mesh axis too.
  memory                     ``argument_bytes``, ``output_bytes`` and
                             ``alias_bytes`` (donated arguments the step
                             updates in place) per device, exactly, from the
                             plan's shard shapes.  ``temp_bytes``: the most
                             storage bytes rank 0 holds at any op of a
                             full-depth run (each storage rounded up to 512
                             bytes, as the CUDA caching allocator counts it)
                             less its arguments'; ``peak_estimate_bytes`` =
                             arguments + outputs + temp − alias.
  roofline                   ``compute_s`` and ``memory_s`` over the H100
                             SXM's own rates (NVIDIA H100 Tensor Core GPU
                             datasheet: 989e12 FLOP/s dense bf16, 3.35e12 B/s
                             HBM3); ``collective_s`` each mesh axis's bytes
                             over its link (``link_rate``: NVLink 4 within an
                             8-card node, the DGX H100's 400 Gb/s network
                             port a card across nodes); ``memory_s_fused_est``
                             is null: it reads XLA's fusions, and eager
                             PyTorch has none.

An ``ok`` record's ``reason`` (the reference's key of a skipped cell's
record) says which of these numbers come otherwise than the reference's:
the flash kernel's formula, the partitioned run, or TeraAgent's stepped
mesh and branches.  Every cell the reference plans is partitioned: a cell
whose partition raises (an op DTensor has no rule for) fails, its record
naming the error and the port's line, and the CLI exits non-zero.

``collective_bytes_from_hlo``, ``fused_bytes_from_hlo`` and
``_strip_done_ops`` parse XLA HLO and have no counterpart.  The
layer-extrapolated costs (``extrapolated_costs``) keep the reference's g /
2g-layer difference, collectives included; eager PyTorch counts every layer
it runs, so here the difference only saves host time, and it equals a direct
full-depth count.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch teraagent --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced --mesh-shape 4x4

Records go to ``results/dryrun_torch/`` (the reference writes
``results/dryrun/``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import sys
import time
import traceback
import weakref
from fractions import Fraction
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as sh
from repro_torch import training
from repro_torch.configs import (ARCHS, SHAPES, ModelConfig, ShapeSpec, get_config,
                                 input_specs, reduced_config, shape_applicable)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import block_visible
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

# ---------------------------------------------------------------------------
# H100 SXM rates (roofline denominators), NVIDIA's H100 datasheet
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12       # dense bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12          # B/s, HBM3
# Links (collective_s): NVLink 4 between the 8 cards of a node, 900 GB/s a
# card both ways (H100 datasheet); between nodes the DGX H100's eight 400
# Gb/s ConnectX-7 ports, one a card (DGX H100 datasheet).  A direction each.
NODE = 8
NVLINK_BW = 450e9
NETWORK_BW = 50e9

FLASH_TILE = 64           # the flash kernels' (query, key) tile
ALLOC_BLOCK = 512         # the CUDA caching allocator's rounding

OUT_DIR = "results/dryrun_torch"

_ONE_DEVICE = make_mesh((1, 1), ("data", "model"), devices="meta")

_ALLOCATIONS = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
})


class SkipCell(Exception):
    pass


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """One cell's step: ``step(*args)`` on the meta tensors ``args``, whose
    ``TensorSpec`` trees (with shardings) are ``specs_in``; ``donate`` are
    the argument positions updated in place (the reference's
    ``donate_argnums``); ``specs`` the reference's sharding constraints
    (``residual``, ``expert``, ``context``; None where it sets none).
    ``out_specs(outputs)`` gives the step's outputs as ``TensorSpec``s from
    the outputs of a run at any depth: a donated argument updated in place
    keeps its spec, and the other outputs (metrics, logits) have the same
    shapes at every depth."""

    kind: str
    cfg: Optional[ModelConfig]
    mesh: Any
    step: Optional[Callable]
    args: Tuple[Any, ...]
    specs_in: Tuple[Any, ...]
    donate: Tuple[int, ...] = ()
    specs: Dict[str, Optional[sh.PartitionSpec]] = dataclasses.field(default_factory=dict)
    out_specs: Optional[Callable] = None
    model: Any = None
    dmesh: Any = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def mesh_size(self) -> int:
        return math.prod(self.mesh.shape.values())

    def run(self):
        if self.dmesh is None:
            return self.step(*self.args)
        # Plain tensors the step makes (positions, masks, zeros) are the
        # same on every rank: replicated.
        with implicit_replication():
            return self.step(*self.args)


def partition(plan: Plan, dmesh) -> Plan:
    """``plan`` as one rank's program on ``dmesh`` (a ``DeviceMesh`` of the
    plan's mesh): its arguments distributed by their shardings
    (``sharding.distribute_tree``: meta local shards for meta arguments),
    and the model's hooks set from ``plan.specs``.  The reference pins the
    GQA-folded query blocks ``(B, Hkv, group·nq, block_q, D)`` on dim 2; the
    port's folded rows ``(B, Hkv, group·T, D)`` take the same split."""
    hook = lambda spec: None if spec is None else sh.Constraint(dmesh, spec)
    context = plan.specs.get("context")
    plan.model.residual_sharding = hook(plan.specs.get("residual"))
    plan.model.expert_sharding = hook(plan.specs.get("expert"))
    plan.model.context_sharding = hook(None if context is None else sh.P(*context[:4]))
    plan.model.weight_gather = sh.gather_weights
    args = tuple(sh.distribute_tree(a, s, dmesh) for a, s in zip(plan.args, plan.specs_in))
    return dataclasses.replace(plan, args=args, dmesh=dmesh)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in ("pod", "data") if a in mesh.shape)


def _shape(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def lower_cell(arch: str, shape_name: Union[str, ShapeSpec], mesh,
               sequence_parallel: bool = True, cfg: Optional[ModelConfig] = None) -> Plan:
    """Plan one (arch × shape) on the mesh, with the reference's config rules
    (``dryrun.py:180-237``); ``cfg`` (default: the arch's) plans other
    configurations, as ``extrapolated_costs`` and ``chip_smoke.py`` do."""
    if cfg is None:
        cfg = get_config(arch)
    shape = _shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(reason)

    specs: Dict[str, Optional[sh.PartitionSpec]] = {
        "residual": (sh.activation_spec(mesh, sequence_parallel)
                     if shape.kind == "train" else None),
        # The MoE dispatch buffer's expert dim pinned to the tensor axis.
        "expert": sh.P("model", None, None) if cfg.is_moe else None,
        "context": None,
    }
    # When the q-head count does not divide the tensor axis, the reference
    # shards the query-block (context) dim over "model" instead, shrinking
    # block_q until the GQA-folded block count divides it.
    model_size = mesh.shape.get("model", 1)
    if shape.kind in ("train", "prefill") and cfg.n_heads % model_size != 0:
        dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
        group = cfg.n_heads // cfg.n_kv_heads
        bq = cfg.attention_block_q
        while bq > 128 and (group * (shape.seq_len // bq)) % model_size != 0:
            bq //= 2
        if (group * (shape.seq_len // bq)) % model_size == 0:
            if bq != cfg.attention_block_q:
                cfg = dataclasses.replace(cfg, attention_block_q=bq)
            specs["context"] = sh.P(dp, None, "model", None, None)
    model = build_model(cfg)

    batch = input_specs(cfg, shape)
    batch_sh = sh.batch_specs(mesh, batch)

    def batch_rule(out):
        return training.attach_shardings(out, sh.batch_specs(mesh, out))

    if shape.kind == "train":
        state, axes = training.eval_train_state(model)
        st_sh = training.state_shardings(mesh, state, axes)
        step_fn = training.make_train_step(model, adamw.AdamWConfig())
        state_in = training.attach_shardings(state, st_sh)
        replicated = lambda _, t: sh.TensorSpec(tuple(t.shape), t.dtype,
                                                sh.NamedSharding(mesh, sh.P()))
        return Plan(
            "train", cfg, mesh, step_fn, (state, batch),
            (state_in, training.attach_shardings(batch, batch_sh)),
            donate=(0,), specs=specs, model=model,
            out_specs=lambda out: (state_in, sh.tree_map_with_keys(replicated, out[1])))

    params, axes = training.eval_params(model)
    p_sh = sh.param_shardings(mesh, params, axes)
    params_in = training.attach_shardings(params, p_sh)

    if shape.kind == "prefill":
        step_fn = training.make_prefill_step(model)
        return Plan("prefill", cfg, mesh, step_fn, (params, batch),
                    (params_in, training.attach_shardings(batch, batch_sh)),
                    specs=specs, out_specs=batch_rule, model=model)

    # decode: one token against a seq_len-deep cache, donated
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    c_sh = sh.cache_shardings(mesh, cache, cfg.n_kv_heads)
    tokens = batch["tokens"]
    tok_sh = (sh.batch_sharding(mesh) if shape.global_batch % _dp_size(mesh) == 0
              else sh.NamedSharding(mesh, sh.P()))
    pos = torch.empty((), dtype=torch.int32, device="meta")
    serve_step = training.make_decode_step(model)
    # The step reads the position on the host; its value changes no shape.
    step_fn = lambda p, c, t, _pos: serve_step(p, c, t, shape.seq_len - 1)
    cache_in = training.attach_shardings(cache, c_sh)
    return Plan(
        "decode", cfg, mesh, step_fn, (params, cache, tokens, pos),
        (params_in, cache_in, sh.TensorSpec(tuple(tokens.shape), tokens.dtype, tok_sh),
         sh.TensorSpec((), torch.int32, sh.NamedSharding(mesh, sh.P()))),
        donate=(1,), specs=specs, model=model,
        out_specs=lambda out: (batch_rule(out[0]), cache_in))


def teraagent_config(mesh):
    """The reference's TeraAgent cell (``dryrun.py:355``): 1M agents a
    device, halo 32k, migration 8k, int16 codec."""
    from repro_torch.core.distributed import DomainConfig

    axes = tuple(a for a in ("data", "model", "pod") if a in mesh.shape)
    sizes = tuple(mesh.shape[a] for a in axes)
    extent, halo = 64.0, 2.0
    dcfg = DomainConfig(
        mesh_axes=axes, axis_sizes=sizes, extent=extent, halo_width=halo,
        halo_capacity=1 << 15, migrate_capacity=1 << 13,
        depth=extent if len(axes) < 3 else 0.0, halo_codec="int16",
    )
    return dcfg, 1 << 20


def teraagent_state(dcfg, capacity: int, device="meta"):
    """The ranks' state stacked on a leading rank axis (``init_dist_state``
    with no agents), on ``device``."""
    from repro_torch.core.distributed import init_dist_state

    return init_dist_state(dcfg, capacity, np.zeros((0, 3), np.float32), device=device)


def teraagent_engine(dcfg):
    """The reference's engine settings (``dryrun.py:367-376``: box 2, 32 a
    cell, Brownian motion 0.05, mechanics, dt 0.05, sorted every 16 steps)
    on the port's kernels: the fused cell-list force and the cell-rank
    kernel (the reference's plan runs its dense force and XLA's rank)."""
    from repro_torch.core import EngineConfig, ForceParams
    from repro_torch.core.behaviors import brownian_motion

    return EngineConfig(
        spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32, rank_impl="cuda"),
        behaviors=(brownian_motion(0.05),), force_params=ForceParams(), dt=0.05,
        min_bound=0.0, max_bound=dcfg.extent, sort_frequency=16, force_impl="fused")


def stepped_mesh(mesh):
    """The mesh a TeraAgent plan steps: the same axes, 2 ranks an axis (a
    rank's bytes and work do not depend on the axis sizes: every buffer has
    the cell's capacities)."""
    return make_mesh(tuple(min(n, 2) for n in mesh.shape.values()), tuple(mesh.shape),
                     devices="meta")


def teraagent_branches(dcfg, ecfg, capacity: int = 4096, agents: int = 2000,
                       seed: int = 0) -> Dict[str, bool]:
    """The force passes' branches (``forces.Branches``) that one eager CPU
    step records for this domain and engine: ``agents`` seeded uniformly
    over the domain in a pool of ``capacity`` a rank."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.forces import Branches

    cpu = make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices="cpu")
    extent = [dcfg.extent * n for n in dcfg.axis_sizes] + [dcfg.extent] * (3 - dcfg.n_decomposed)
    pos = np.random.default_rng(seed).uniform(0.0, extent, (agents, 3)).astype(np.float32)
    state = dist.init_dist_state(dcfg, capacity, pos, diameter=1.0, seed=seed)
    branches = Branches()
    dist.step_ranks(cpu, dist.distributed_scheduler(dcfg, ecfg),
                    dist.unstack_state(state, cpu.devices), 0, branches=branches)
    return dict(branches.taken)


def lower_teraagent(mesh) -> Plan:
    """The paper's own workload: the lock-step step of every rank
    (``distributed.step_ranks``) on one ``DistState`` a rank, on meta.  The
    specs are the production mesh's (one rank's state a device); the step
    runs on :func:`stepped_mesh`, its force passes taking the branches an
    eager CPU step records (:func:`teraagent_branches`, in ``extras``)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.forces import Branches
    from repro_torch.core.slots import tree_map

    dcfg, capacity = teraagent_config(mesh)
    leading = sh.NamedSharding(mesh, sh.P(dcfg.mesh_axes))
    specs_in = sh.tree_map_with_keys(
        lambda _, t: sh.TensorSpec(tuple(t.shape), t.dtype, leading),
        _tensor_tree(teraagent_state(dcfg, capacity)))

    small = stepped_mesh(mesh).ordered(dcfg.mesh_axes)
    sdcfg, _ = teraagent_config(small)
    ecfg = teraagent_engine(sdcfg)
    assumed = teraagent_branches(sdcfg, ecfg)
    scheduler = dist.distributed_scheduler(sdcfg, ecfg)
    # One state a rank, each with storage of its own (the rank's share).
    ranks = [tree_map(torch.clone, r)
             for r in dist.unstack_state(teraagent_state(sdcfg, capacity), small.devices)]
    diverged = torch.zeros((), dtype=torch.bool, device="meta")

    def step(ranks):
        return dist.step_ranks(small, scheduler, ranks, 0,
                               branches=Branches(assumed, diverged))

    return Plan("abm_step", None, mesh, step, (ranks,), (specs_in,),
                out_specs=lambda out: specs_in,
                extras={"stepped_mesh": small.axis_sizes, "branches": assumed})


def _tensor_tree(tree):
    """Dataclass states (``DistState``, ``AgentPool``, …) as dicts of their
    fields, down to the tensors."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _tensor_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def tree_tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def _block(n: int) -> int:
    """Bytes the caching allocator counts for an ``n``-byte request."""
    return 0 if n == 0 else -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is running: it runs each op on
    fake tensors of the global shapes, which no device runs."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return t.to_local() if sh.is_dtensor(t) else t


# The ``_c10d_functional`` collectives, by the kinds of the reference's
# ``collective_bytes_from_hlo``; the other ops of the namespace (waits,
# autograd wrappers) move nothing.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D_NOOPS = ("wait_tensor", "_wrap_tensor_autograd")


def _collective(func) -> Optional[str]:
    """The kind of a ``_c10d_functional`` op, "" for one that moves nothing,
    None for any other op; raises on a collective with no kind."""
    if not func.namespace.startswith("_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    if name in _C10D_KINDS:
        return _C10D_KINDS[name]
    if name in _C10D_NOOPS:
        return ""
    raise NotImplementedError(f"no collective kind for {func}")


def collective_bytes(counts: Dict[Tuple[str, str], int]) -> Dict[str, int]:
    """The record's ``collective_bytes_per_device`` from bytes keyed by
    (kind, axis or group): every kind, and ``total``."""
    out = {k: 0 for k in COLLECTIVES}
    for (kind, _), n in counts.items():
        out[kind] += n
    out["total"] = sum(out.values())
    return out


def link_rate(mesh, axis: str) -> float:
    """B/s a device sends along ``axis`` of ``mesh`` (ranks numbered x-major
    over the axes, ``NODE`` cards a node): NVLink 4 where every group of the
    axis lies within one node, else the node's network."""
    names = tuple(mesh.shape)
    stride = math.prod(list(mesh.shape.values())[names.index(axis) + 1:])
    span = stride * mesh.shape[axis]
    return NVLINK_BW if span <= NODE and NODE % span == 0 else NETWORK_BW


def collective_seconds(mesh, by_axis: Dict[Tuple[str, str], int]) -> float:
    """Each axis's collective bytes over its link rate, summed."""
    return sum(n / link_rate(mesh, axis) for (_, axis), n in by_axis.items())


class RankScope:
    """``distributed.rank_scope`` for the dry-run: ``rank`` is the rank whose
    work is running (None outside every rank's)."""

    def __init__(self):
        self.rank: Optional[int] = None

    @contextlib.contextmanager
    def __call__(self, rank: int):
        outer, self.rank = self.rank, rank
        try:
            yield
        finally:
            self.rank = outer


class _LocalFlops(FlopCounterMode):
    """``FlopCounterMode`` over the ops a device runs: not those of DTensor's
    sharding propagation.  With a ``scope``, ``by_rank`` holds each rank's
    FLOPs (key None: outside every rank's work)."""

    def __init__(self, scope: Optional[RankScope] = None, **kw):
        super().__init__(**kw)
        self.scope = scope
        self.by_rank: Dict[Optional[int], int] = collections.Counter()

    def _count_flops(self, func_packet, out, args, kwargs):
        if _propagating():
            return out
        if self.scope is not None and func_packet in self.flop_registry:
            self.by_rank[self.scope.rank] += self.flop_registry[func_packet](
                *args, **kwargs, out_val=out)
        return super()._count_flops(func_packet, out, args, kwargs)


class OpCounter(TorchDispatchMode):
    """Counts, over the aten ops run under it: ``bytes`` read and written
    (operands and results; view ops and bare allocations excluded), and the
    storage bytes alive (each storage in 512-byte blocks, freed when its
    last tensor dies), ``peak`` being the most at any op.  ``args``' storages
    are alive from the start (``arg_bytes``).

    Over DTensors it counts one rank's ops: a DTensor op is handed on to
    DTensor (``NotImplemented``), whose ops on the local shards and
    ``_c10d_functional`` collectives then come through here; the ops of its
    sharding propagation are not counted.  ``collectives`` sums each
    collective's operand bytes by kind, as ``collective_bytes_from_hlo``
    does, keyed by (kind, process group name); a collective adds no
    ``bytes``.  Entered last (innermost), it keeps
    the modes under it (``_LocalFlops``) from seeing DTensor ops.

    With a ``scope`` (the lock-step ABM step), ``args`` holds one tree a
    rank and every op and storage also counts for the rank whose work made
    it: ``ranks[r]`` has its ``bytes``, ``live``, ``peak`` and ``args``
    (key None: outside every rank's work)."""

    def __init__(self, args=(), scope: Optional[RankScope] = None):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.collectives: Dict[str, int] = {}
        self.scope = scope
        self.ranks: Dict[Optional[int], Dict[str, int]] = {}
        self._sizes: Dict[int, Tuple[int, Optional[int]]] = {}
        owned = enumerate(args) if scope is not None else [(None, args)]
        for rank, tree in owned:
            for t in tree_tensors(tree):
                self._track(_local(t), rank)
        self.arg_bytes = self.live
        self.peak = self.live
        for r in self.ranks.values():
            r["args"] = r["peak"] = r["live"]

    def _rank(self, rank: Optional[int]) -> Dict[str, int]:
        if rank not in self.ranks:
            self.ranks[rank] = {"bytes": 0, "live": 0, "peak": 0, "args": 0}
        return self.ranks[rank]

    def _track(self, t: torch.Tensor, rank: Optional[int]) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = _block(st.nbytes())
        self._sizes[key] = (n, rank)
        self.live += n
        own = self._rank(rank)
        own["live"] += n
        own["peak"] = max(own["peak"], own["live"])
        weakref.finalize(st, self._free, key)

    def _alias(self, new: torch.Tensor, old: torch.Tensor) -> None:
        if type(new) is not torch.Tensor:    # an async wrapper of ``old`` itself
            return
        kn, ko = new.untyped_storage()._cdata, old.untyped_storage()._cdata
        if kn == ko or kn in self._sizes or ko not in self._sizes:
            return
        self._sizes[kn] = self._sizes.pop(ko)
        weakref.finalize(new.untyped_storage(), self._free, kn)

    def _free(self, key: int) -> None:
        n, rank = self._sizes.pop(key, (0, None))
        self.live -= n
        self._rank(rank)["live"] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.is_view or _propagating():   # no bytes moved, no storage made
            return out
        results = _flat(out)
        rank = None if self.scope is None else self.scope.rank
        kind = _collective(func)
        if kind:
            group = next(a for a in reversed(args) if isinstance(a, str))
            key = (kind, group)
            self.collectives[key] = (self.collectives.get(key, 0)
                                     + sum(t.nbytes for t in _flat(args[:1])))
        elif kind == "" and func._schema.name.endswith("_wrap_tensor_autograd"):
            # A wrapper of its input, which its meta kernel copies: the
            # input's storage is counted once, for as long as the result lives.
            for new, old in zip(results, _flat(args)):
                self._alias(new, old)
            return out
        elif kind is None and func not in _ALLOCATIONS:
            moved = sum(t.nbytes for t in _flat(args) + _flat(list(kwargs.values())) + results)
            self.bytes += moved
            self._rank(rank)["bytes"] += moved
        for t in results:
            self._track(t, rank)
        if self.live > self.peak:
            self.peak = self.live
        return out


def _flat(xs) -> list:
    """The tensors of an op's arguments or results (a tensor, or a sequence
    of tensors and lists of tensors): ``tree_tensors`` for aten calls, one
    level deep, as it runs at every op."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    out = []
    for x in xs if isinstance(xs, (list, tuple)) else ():
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


@functools.lru_cache(maxsize=None)
def visible_tiles(tq: int, tk: int, causal: bool, window: Optional[int], prefix_len: int,
                  kv_offset: int = 0) -> int:
    """(64-query, 64-key) tiles holding a visible (query, key) pair."""
    n = 0
    for q0 in range(0, tq, FLASH_TILE):
        q_lo, q_hi = q0 + kv_offset, min(q0 + FLASH_TILE, tq) - 1 + kv_offset
        for k0 in range(0, tk, FLASH_TILE):
            n += block_visible(q_lo, q_hi, k0, min(k0 + FLASH_TILE, tk) - 1, causal, window,
                               prefix_len)
    return n


def flash_attention_flops(q_shape, k_shape, causal: bool, window: Optional[int],
                          prefix_len: int, kv_offset: int = 0) -> int:
    """The flash kernel's FLOPs for one call: 4 · D for every (query, key)
    pair of the visible 64 × 64 tiles, over every (batch, query head)."""
    b, hq, tq, d = q_shape
    tiles = visible_tiles(tq, k_shape[2], causal, window, prefix_len, kv_offset)
    return 4 * d * tiles * FLASH_TILE ** 2 * b * hq


@contextlib.contextmanager
def _no_gc():
    """Python's cycle collector off (after a collection), for the lock-step
    ABM step: a storage held in a reference cycle then lives to the end of
    the step on every rank alike, not to wherever a collection happens to
    run in the middle of one rank's work."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def step_costs(plan: Plan) -> Dict[str, Any]:
    """One step of ``plan`` on meta under the counters: ``flops`` (the aten
    ops' and the flash kernel's), ``bytes``, ``peak`` and ``arg_live`` (the
    live storage bytes at the worst op and of the arguments), ``outputs``."""
    flash = []
    observer = lambda *call: flash.append(flash_attention_flops(*call))
    fa_kernel.meta_observers.append(observer)
    try:
        with _LocalFlops(display=False) as fc, OpCounter(plan.args) as ops:
            outputs = plan.run()
    finally:
        fa_kernel.meta_observers.remove(observer)
    axes = {}
    if plan.dmesh is not None:
        axes = {plan.dmesh.get_group(i).group_name: a
                for i, a in enumerate(plan.dmesh.mesh_dim_names)}
    coll = collections.Counter()
    for (kind, group), n in ops.collectives.items():
        coll[kind, axes[group]] += n
    return {"flops": fc.get_total_flops() + sum(flash), "bytes": ops.bytes,
            "peak": ops.peak, "arg_live": ops.arg_bytes, "outputs": outputs,
            "collectives": dict(coll)}


def abm_costs(plan: Plan) -> Dict[str, Any]:
    """The lock-step ABM step of ``plan`` on meta, rank 0's share: its
    ``flops``, ``bytes``, ``peak`` and ``arg_live``, and the bytes it sends
    through ``Mesh.shift`` (``collectives``, by ("collective-permute",
    axis)).  Raises unless every rank's FLOPs, bytes, arguments and shifted
    bytes are equal and their peaks within two 512-byte blocks (the lock-step
    order lets a rank's scalar temporary outlive another's peak).  ``attributed``:
    whether every op and storage ran as some rank's work.  A first step,
    not counted, makes the constants the step keeps on its device
    (``grid.device_constant``), as the compiled run's warm-up step does; one
    device's ranks share them here, where each card would make its own."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import count_shift_bytes

    plan.run()
    scope = RankScope()
    ranks = plan.args[0]
    outer, dist.rank_scope = dist.rank_scope, scope
    try:
        with _no_gc(), count_shift_bytes() as sent, \
                _LocalFlops(scope=scope, display=False) as fc, OpCounter(ranks, scope=scope) as ops:
            outputs = plan.run()
    finally:
        dist.rank_scope = outer
    share = {r: (fc.by_rank[r], ops.ranks[r]["bytes"], ops.ranks[r]["args"], sent.on_axes(r))
             for r in range(len(ranks))}
    peaks = [ops.ranks[r]["peak"] for r in range(len(ranks))]
    if any(v != share[0] for v in share.values()) or max(peaks) - min(peaks) > 2 * ALLOC_BLOCK:
        raise AssertionError(f"the ranks' shares of the step differ: {share}, peaks {peaks}")
    flops, moved, args, axes = share[0]
    peak = peaks[0]
    outside = ops.ranks.get(None, {})
    return {"flops": flops, "bytes": moved, "peak": peak, "arg_live": args,
            "collectives": {("collective-permute", a): n for a, n in axes.items()},
            "outputs": outputs,
            "attributed": fc.by_rank[None] == 0 and not outside.get("bytes")
            and not outside.get("peak")}


@functools.lru_cache(maxsize=None)
def global_costs(arch: str, shape: ShapeSpec, cfg: ModelConfig, mesh=_ONE_DEVICE,
                 sequence_parallel: bool = True) -> Dict[str, Any]:
    """``step_costs`` of one step of ``cfg`` at ``shape`` on ``mesh``: on one
    device the global counts; on more, rank 0's program over a fake process
    group of the mesh's size (``partition``), the collectives' groups on a
    ``"cuda"`` device mesh, as a deployment's NCCL ones."""
    plan = lower_cell(arch, shape, mesh, sequence_parallel=sequence_parallel, cfg=cfg)
    if math.prod(mesh.shape.values()) == 1:
        return step_costs(plan)
    from repro_torch.launch.mesh import device_mesh, fake_group

    with fake_group(math.prod(mesh.shape.values())):
        return step_costs(partition(plan, device_mesh(mesh, "cuda")))


def extrapolated_costs(arch: str, shape_name: Union[str, ShapeSpec],
                       cfg: Optional[ModelConfig] = None, mesh=_ONE_DEVICE,
                       sequence_parallel: bool = True) -> Dict[str, Any]:
    """Per-layer cost extrapolation from two shallow variants, as the
    reference's: L = g and L = 2g layers (g = the block pattern's length),
    ``total = A + (L_full − g)/g · (B − A)``, exact (a fraction) where g
    divides L_full.  XLA counts a while-loop body once, so the reference
    needs it; eager PyTorch counts every layer it runs, so here it only saves
    host time and equals a direct full-depth count.  On a one-device mesh
    the counts are global; on more, rank 0's (``global_costs``), the
    collectives' bytes extrapolated kind by kind and axis by axis."""
    cfg0 = get_config(arch) if cfg is None else cfg
    shape = _shape(shape_name)
    g = len(cfg0.block_pattern)
    l_full = cfg0.n_layers
    enc_a = max(1, round(cfg0.n_encoder_layers * g / l_full)) if cfg0.is_encoder_decoder else 0
    a, b = (global_costs(arch, shape, dataclasses.replace(cfg0, n_layers=k * g,
                                                          n_encoder_layers=k * enc_a),
                         mesh, sequence_parallel)
            for k in (1, 2))
    factor = Fraction(l_full - g, g)

    def total(x, y):
        v = x + factor * (y - x)
        return int(v) if v.denominator == 1 else float(v)

    coll = {k: total(a["collectives"].get(k, 0), b["collectives"].get(k, 0))
            for k in set(a["collectives"]) | set(b["collectives"])}
    return {"flops": total(a["flops"], b["flops"]), "bytes": total(a["bytes"], b["bytes"]),
            "collectives": coll, "outputs": a["outputs"],
            "shallow_a": {k: a[k] for k in ("flops", "bytes")},
            "shallow_b": {k: b[k] for k in ("flops", "bytes")}}


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

def spec_bytes(specs) -> int:
    """Per-device bytes of a ``TensorSpec`` tree."""
    return sum(s.shard_nbytes for s in _spec_leaves(specs))


def _spec_leaves(tree) -> list:
    if isinstance(tree, sh.TensorSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _spec_leaves(v)]
    return []


def plan_memory(plan: Plan, outputs=None, full: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """The record's ``memory``: per-device argument, output and alias bytes
    from the plan's shard shapes (``outputs``: the step's outputs at any
    depth); temp and peak from ``full`` (one device's counts of a full-depth
    step: ``step_costs`` / ``abm_costs``), else null."""
    args = spec_bytes(plan.specs_in)
    alias = sum(spec_bytes(plan.specs_in[i]) for i in plan.donate)
    out = spec_bytes(plan.out_specs(outputs))
    temp = peak = None
    if full is not None:
        temp = full["peak"] - full["arg_live"]
        peak = args + out + temp - alias
    return dict(argument_bytes=args, output_bytes=out, temp_bytes=temp, alias_bytes=alias,
                peak_estimate_bytes=peak)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: Union[str, ShapeSpec], mesh_kind: str,
             out_dir: Optional[str], sequence_parallel: bool = True, verbose: bool = True,
             mesh=None, cfg: Optional[ModelConfig] = None) -> Dict:
    """One cell's record.  ``mesh`` (default: the production mesh of
    ``mesh_kind``) and ``cfg`` (default: the arch's) plan other cells, as
    ``chip_smoke.py``'s ``dryrun`` phase does for its one-device steps."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = math.prod(mesh.shape.values())
    shape = _shape(shape_name)
    t0 = time.time()
    record: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_kind, "chips": n_chips}
    try:
        if arch == "teraagent":
            plan = lower_teraagent(mesh)
            record["kind"] = "abm_step"
        else:
            plan = lower_cell(arch, shape, mesh, sequence_parallel=sequence_parallel, cfg=cfg)
            record["kind"] = shape.kind
    except SkipCell as e:
        record["status"] = "skipped"
        record["reason"] = str(e)
        if verbose:
            print(f"[SKIP] {arch} × {shape.name} × {mesh_kind}: {e}")
        _write(out_dir, record)
        return record

    t_lower = time.time() - t0
    notes = []
    if plan.kind == "abm_step":
        costs = abm_costs(plan)
        full = costs if costs["attributed"] else None
        notes.append(
            f"the step runs on a {plan.extras['stepped_mesh']} mesh of the same axes (2 ranks "
            "an axis): a rank's work and bytes do not depend on the axis sizes; its force "
            "passes take the branches an eager CPU step records ("
            + ", ".join(f"{k}={v}" for k, v in sorted(plan.extras["branches"].items()))
            + "); flops: products only (FlopCounterMode), of which the agent step has few; "
            "the force and rank kernels' stand-ins count no bytes")
        if full is None:
            notes.append("temp_bytes: some of the step's storage is no rank's own work")
    else:
        if plan.cfg.attention_impl == "cuda":
            notes.append("flops: the flash kernel is no aten op; its visible-tile formula "
                         "counts its attention")
        # A partition that raises fails the cell: every cell the reference
        # plans is partitioned here too.
        costs = extrapolated_costs(arch, shape, cfg=plan.cfg, mesh=mesh,
                                   sequence_parallel=sequence_parallel)
        full = global_costs(arch, shape, plan.cfg, mesh, sequence_parallel)
        if n_chips > 1:
            notes.append("rank 0's program over a fake process group of the mesh's "
                         "size (DTensor): its local ops and collectives")
    flops, bytes_acc = costs["flops"], costs["bytes"]
    memory = plan_memory(plan, costs["outputs"], full)
    coll = costs["collectives"]
    if notes:
        record["reason"] = "; ".join(notes)
    t_compile = time.time() - t0 - t_lower

    record.update(
        status="ok",
        lower_s=round(t_lower, 2),
        compile_s=round(t_compile, 2),
        flops_per_device=flops,
        bytes_accessed_per_device=bytes_acc,
        collective_bytes_per_device=collective_bytes(coll),
        memory=memory,
        roofline=dict(
            compute_s=flops / PEAK_FLOPS,
            memory_s=bytes_acc / HBM_BW,
            # XLA's fusions, which this reads in the reference, have no
            # counterpart in eager PyTorch.
            memory_s_fused_est=None,
            collective_s=collective_seconds(mesh, coll),
        ),
    )
    terms = record["roofline"]
    record["roofline"]["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                                         key=lambda k: terms[k])
    if arch != "teraagent":
        tokens = shape.global_batch * (1 if record["kind"] == "decode" else shape.seq_len)
        n_active = plan.cfg.params_active()
        model_flops_global = (6 if record["kind"] == "train" else 2) * n_active * tokens
        record["model_flops_per_device"] = model_flops_global / n_chips
        record["useful_flops_fraction"] = (
            record["model_flops_per_device"] / flops if flops else 0.0
        )
    if verbose:
        r = record["roofline"]
        print(f"[OK] {arch} × {shape.name} × {mesh_kind}: plan {record['lower_s']}s, "
              f"count {record['compile_s']}s, compute {r['compute_s']*1e3:.2f}ms, "
              f"mem {r['memory_s']*1e3:.2f}ms, coll {(r['collective_s'] or 0)*1e3:.2f}ms "
              f"→ {r['dominant']}")
        print(f"     memory: {record['memory']}")
        print(f"     collectives: {record['collective_bytes_per_device']}")
        print("     by axis: " + json.dumps({f"{k}/{a}": n for (k, a), n in sorted(coll.items())}))
    _write(out_dir, record)
    return record


def _failed_op(e: BaseException) -> str:
    """Where a cell failed (a failed cell's record): the port's innermost
    line in the traceback, and the error's first line."""
    where = ""
    for frame in traceback.extract_tb(e.__traceback__):
        if f"{os.sep}repro_torch{os.sep}" in frame.filename:
            path = frame.filename.split(f"{os.sep}repro_torch{os.sep}")[-1]
            where = f"{path}:{frame.lineno} `{(frame.line or '').strip()}` "
    msg = str(e).strip().splitlines()
    return f"{where}({type(e).__name__}{': ' + msg[0][:200] if msg else ''})"


def _write(out_dir, record):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['mesh']}__{record['arch']}__{record.get('shape', '-')}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def reduced_cell_config(arch: str) -> ModelConfig:
    """``arch``'s reduced config (``configs.reduced_config``: narrow, two
    pattern groups deep) with the full config's attention blocks, rwkv6
    chunk and remat, so that its loops over a cell's sequence take the full
    config's steps."""
    full = get_config(arch)
    return reduced_config(arch, attention_block_q=full.attention_block_q,
                          attention_block_k=full.attention_block_k, rwkv_chunk=full.rwkv_chunk,
                          remat=full.remat)


def grid_cells(arch: Optional[str] = None, shape: Optional[str] = None):
    """The cells of ``--all`` (every arch × shape, then ``teraagent``), or of
    one arch."""
    if arch is None:
        return [(a, s) for a in sorted(ARCHS) for s in SHAPES] + [("teraagent", "train_4k")]
    if arch == "teraagent":
        return [(arch, "train_4k")]
    return [(arch, s) for s in ([shape] if shape else list(SHAPES))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id or 'teraagent'")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every (arch × shape)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-sp", action="store_true", help="disable sequence parallelism")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="plan on a mesh of this shape instead of the production meshes: "
                         "DxM (data, model) or PxDxM (pod, data, model), e.g. 4x4")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config (reduced_cell_config)")
    args = ap.parse_args(argv)

    if args.mesh_shape:
        dims = tuple(int(n) for n in args.mesh_shape.split("x"))
        axes = ("pod", "data", "model")[-len(dims):]
        meshes = [(args.mesh_shape, make_mesh(dims, axes, devices="meta"))]
    else:
        meshes = [(k, None) for k in (["single", "multi"] if args.mesh == "both"
                                      else [args.mesh])]
    if not args.all and not args.arch:
        ap.error("--arch required without --all")
    cells = grid_cells(None if args.all else args.arch, args.shape)

    failures = []
    for mesh_kind, mesh in meshes:
        for arch, shape in cells:
            name = f"{mesh_kind}__{arch}__{shape}.json"
            if args.skip_existing and os.path.exists(os.path.join(args.out, name)):
                print(f"[cached] {name}")
                continue
            cfg = reduced_cell_config(arch) if args.reduced and arch != "teraagent" else None
            try:
                run_cell(arch, shape, mesh_kind, args.out, sequence_parallel=not args.no_sp,
                         mesh=mesh, cfg=cfg)
            except Exception as e:
                traceback.print_exc()
                failures.append((mesh_kind, arch, shape, repr(e)))
                _write(args.out, {
                    "arch": arch, "shape": shape, "mesh": mesh_kind,
                    "status": "failed", "error": _failed_op(e),
                })
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
