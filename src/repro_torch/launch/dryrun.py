"""Dry-run of the port: every (architecture × input shape × mesh) cell
planned on the meta device, with no card and no storage.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell against ``ShapeDtypeStruct``s on 512 fake host devices and reads XLA's
``memory_analysis`` and ``cost_analysis``.  Here, for every cell:

    plan  = lower_cell(arch, shape, mesh)   # the step's arguments as sharded
                                            # TensorSpecs (repro_torch.sharding)
    costs = the step run on meta tensors under FlopCounterMode and a
            dispatch mode that counts bytes and live storage

and a JSON record with the reference's fields and units:

  flops_per_device           ``torch.utils.flop_counter.FlopCounterMode``
                             over one step on meta at the cell's global
                             shapes, split evenly over the mesh's devices
                             (eager PyTorch has no SPMD partitioner to say
                             otherwise).  With ``attention_impl="cuda"`` the
                             flash kernel is not an aten op: each call adds
                             ``flash_attention_flops`` (4 · D FLOPs for every
                             (query, key) pair of each 64 × 64 tile that
                             holds a visible pair, as ``chip_smoke.py``
                             bounds the kernel); with ``"chunked"`` (the
                             configs' default) the counter sees the plain
                             version's products.
  bytes_accessed_per_device  every aten op's operand and result bytes, as
                             XLA:CPU's ``bytes accessed`` counts them; view
                             ops move nothing and allocations write nothing,
                             so neither counts, and a kernel's stand-in
                             counts only its outputs' allocation (nothing).
  memory                     ``argument_bytes``, ``output_bytes`` and
                             ``alias_bytes`` (donated arguments the step
                             updates in place) per device, exactly, from the
                             plan's shard shapes.  ``temp_bytes``: on a
                             one-device mesh, the most storage bytes alive at
                             any op of a full-depth meta run (each storage
                             rounded up to 512 bytes, as the CUDA caching
                             allocator counts it) less the arguments';
                             ``peak_estimate_bytes`` = arguments + outputs +
                             temp − alias.  On a mesh of more devices both
                             are null: without a partitioner nothing says
                             what one device holds in flight.
  roofline                   ``compute_s`` and ``memory_s`` over the H100
                             SXM's own rates (NVIDIA H100 Tensor Core GPU
                             datasheet: 989e12 FLOP/s dense bf16, 3.35e12 B/s
                             HBM3); ``memory_s_fused_est`` and
                             ``collective_s`` are null: they read compiled
                             HLO (collectives would go over NVLink 4, 450e9
                             B/s per direction).

An ``ok`` record's ``reason`` (the reference's key of a skipped cell's
record) says which of these numbers come otherwise than the reference's:
the flash kernel's formula, a null ``temp_bytes``, a state without a step.

``collective_bytes_from_hlo``, ``fused_bytes_from_hlo`` and
``_strip_done_ops`` parse XLA HLO and have no counterpart; eager PyTorch
decides no collectives.  The reference's sharding constraints (the residual
stream's, the MoE dispatch's, attention's context split) are kept in the
plan (``Plan.specs``): there is no partitioner to apply them to.  The
layer-extrapolated costs (``extrapolated_costs``) keep the reference's g /
2g-layer difference; eager PyTorch counts every layer it runs, so here the
difference only saves host time, and it equals a direct full-depth count.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch teraagent --mesh multi

Records go to ``results/dryrun_torch/`` (the reference writes
``results/dryrun/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as sh
from repro_torch import training
from repro_torch.configs import (ARCHS, SHAPES, ModelConfig, ShapeSpec, get_config,
                                 input_specs, shape_applicable)
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

    @property
    def mesh_size(self) -> int:
        return math.prod(self.mesh.shape.values())

    def run(self):
        return self.step(*self.args)


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
            donate=(0,), specs=specs,
            out_specs=lambda out: (state_in, sh.tree_map_with_keys(replicated, out[1])))

    params, axes = training.eval_params(model)
    p_sh = sh.param_shardings(mesh, params, axes)
    params_in = training.attach_shardings(params, p_sh)

    if shape.kind == "prefill":
        step_fn = training.make_prefill_step(model)
        return Plan("prefill", cfg, mesh, step_fn, (params, batch),
                    (params_in, training.attach_shardings(batch, batch_sh)),
                    specs=specs, out_specs=batch_rule)

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
        donate=(1,), specs=specs,
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


def lower_teraagent(mesh) -> Plan:
    """The paper's own workload: one rank's ``DistState`` a device (the
    stacked state sharded over its leading rank axis).  The agent step syncs
    with the host on data-dependent sizes, which meta tensors cannot run, so
    the plan holds the state and no step."""
    dcfg, capacity = teraagent_config(mesh)
    state = teraagent_state(dcfg, capacity)
    leading = sh.NamedSharding(mesh, sh.P(dcfg.mesh_axes))
    specs_in = sh.tree_map_with_keys(
        lambda _, t: sh.TensorSpec(tuple(t.shape), t.dtype, leading), _tensor_tree(state))
    return Plan("abm_step", None, mesh, None, (state,), (specs_in,))


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


class OpCounter(TorchDispatchMode):
    """Counts, over the aten ops run under it: ``bytes`` read and written
    (operands and results; view ops and bare allocations excluded), and the
    storage bytes alive (each storage in 512-byte blocks, freed when its
    last tensor dies), ``peak`` being the most at any op.  ``args``' storages
    are alive from the start (``arg_bytes``)."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self._sizes: Dict[int, int] = {}
        for t in tree_tensors(args):
            self._track(t)
        self.arg_bytes = self.live
        self.peak = self.live

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = _block(st.nbytes())
        self._sizes[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:                 # no bytes moved, no storage made
            return out
        results = _flat(out)
        if func not in _ALLOCATIONS:
            self.bytes += sum(t.nbytes for t in _flat(args) + _flat(list(kwargs.values()))
                              + results)
        for t in results:
            self._track(t)
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


def step_costs(plan: Plan) -> Dict[str, Any]:
    """One step of ``plan`` on meta under the counters: ``flops`` (the aten
    ops' and the flash kernel's), ``bytes``, ``peak`` and ``arg_live`` (the
    live storage bytes at the worst op and of the arguments), ``outputs``."""
    flash = []
    observer = lambda *call: flash.append(flash_attention_flops(*call))
    fa_kernel.meta_observers.append(observer)
    try:
        with FlopCounterMode(display=False) as fc, OpCounter(plan.args) as ops:
            outputs = plan.run()
    finally:
        fa_kernel.meta_observers.remove(observer)
    return {"flops": fc.get_total_flops() + sum(flash), "bytes": ops.bytes,
            "peak": ops.peak, "arg_live": ops.arg_bytes, "outputs": outputs}


@functools.lru_cache(maxsize=None)
def global_costs(arch: str, shape: ShapeSpec, cfg: ModelConfig) -> Dict[str, Any]:
    """``step_costs`` of one step of ``cfg`` at ``shape``.  The counts are
    global (the mesh changes only the plan's shardings), so each (arch,
    shape, config) is run once, on a one-device mesh, for every mesh."""
    return step_costs(lower_cell(arch, shape, _ONE_DEVICE, cfg=cfg))


def extrapolated_costs(arch: str, shape_name: Union[str, ShapeSpec],
                       cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Per-layer cost extrapolation from two shallow variants, as the
    reference's: L = g and L = 2g layers (g = the block pattern's length),
    ``total = A + (L_full − g)/g · (B − A)``, exact (a fraction) where g
    divides L_full.  XLA counts a while-loop body once, so the reference
    needs it; eager PyTorch counts every layer it runs, so here it only saves
    host time and equals a direct full-depth count.  The counts are global:
    no mesh changes them."""
    cfg0 = get_config(arch) if cfg is None else cfg
    shape = _shape(shape_name)
    g = len(cfg0.block_pattern)
    l_full = cfg0.n_layers
    enc_a = max(1, round(cfg0.n_encoder_layers * g / l_full)) if cfg0.is_encoder_decoder else 0
    a, b = (global_costs(arch, shape, dataclasses.replace(cfg0, n_layers=k * g,
                                                          n_encoder_layers=k * enc_a))
            for k in (1, 2))
    factor = Fraction(l_full - g, g)

    def total(k):
        v = a[k] + factor * (b[k] - a[k])
        return int(v) if v.denominator == 1 else float(v)

    return {"flops": total("flops"), "bytes": total("bytes"), "outputs": a["outputs"],
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
    depth); temp and peak from ``full`` (``step_costs`` at full depth) on a
    one-device mesh, else null."""
    args = spec_bytes(plan.specs_in)
    alias = sum(spec_bytes(plan.specs_in[i]) for i in plan.donate)
    # A plan without a step (the agent state) returns a state of its shapes.
    out = args if plan.step is None else spec_bytes(plan.out_specs(outputs))
    temp = peak = None
    if full is not None and plan.mesh_size == 1:
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
    flops = bytes_acc = None
    if plan.step is None:
        record["reason"] = ("the agent step syncs with the host on data-dependent sizes, "
                            "which meta tensors cannot run: state bytes only")
        memory = plan_memory(plan)
    else:
        full = step_costs(plan) if n_chips == 1 else None
        costs = extrapolated_costs(arch, shape, cfg=plan.cfg)
        flops, bytes_acc = _per_device(costs["flops"], n_chips), _per_device(costs["bytes"],
                                                                              n_chips)
        memory = plan_memory(plan, costs["outputs"], full)
        notes = []
        if plan.cfg.attention_impl == "cuda":
            notes.append("flops: the flash kernel is no aten op; its visible-tile formula "
                         "counts its attention")
        if full is None:
            notes.append("temp_bytes: no partitioner says what one device of a "
                         f"{n_chips}-device mesh holds in flight")
        if notes:
            record["reason"] = "; ".join(notes)
    t_compile = time.time() - t0 - t_lower

    record.update(
        status="ok",
        lower_s=round(t_lower, 2),
        compile_s=round(t_compile, 2),
        flops_per_device=flops,
        bytes_accessed_per_device=bytes_acc,
        collective_bytes_per_device=None,
        memory=memory,
        roofline=dict(
            compute_s=None if flops is None else flops / PEAK_FLOPS,
            memory_s=None if bytes_acc is None else bytes_acc / HBM_BW,
            memory_s_fused_est=None,
            collective_s=None,
        ),
    )
    terms = record["roofline"]
    record["roofline"]["dominant"] = (None if flops is None else max(
        ("compute_s", "memory_s"), key=lambda k: terms[k]))
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
        if flops is None:
            print(f"[OK] {arch} × {shape.name} × {mesh_kind}: state only")
        else:
            print(f"[OK] {arch} × {shape.name} × {mesh_kind}: plan {record['lower_s']}s, "
                  f"count {record['compile_s']}s, compute {r['compute_s']*1e3:.2f}ms, "
                  f"mem {r['memory_s']*1e3:.2f}ms → {r['dominant']}")
        print(f"     memory: {record['memory']}")
    _write(out_dir, record)
    return record


def _per_device(total, n: int):
    """``total / n``: an int where it divides evenly, else a float."""
    v = Fraction(total) / n
    return int(v) if v.denominator == 1 else float(v)


def _write(out_dir, record):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['mesh']}__{record['arch']}__{record.get('shape', '-')}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


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
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all and not args.arch:
        ap.error("--arch required without --all")
    cells = grid_cells(None if args.all else args.arch, args.shape)

    failures = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            name = f"{mesh_kind}__{arch}__{shape}.json"
            if args.skip_existing and os.path.exists(os.path.join(args.out, name)):
                print(f"[cached] {name}")
                continue
            try:
                run_cell(arch, shape, mesh_kind, args.out, sequence_parallel=not args.no_sp)
            except Exception as e:
                traceback.print_exc()
                failures.append((mesh_kind, arch, shape, repr(e)))
                _write(args.out, {
                    "arch": arch, "shape": shape, "mesh": mesh_kind,
                    "status": "failed", "error": repr(e),
                })
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
