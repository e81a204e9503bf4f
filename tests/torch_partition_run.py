"""Partitioned LM steps on a (2, 2) mesh, run for real and planned.

Four gloo ranks (processes) run each case's step over DTensor from the
same seeded full tensors; the parent runs rank 0's program over a fake
process group on meta tensors, and the single-device step on the full
tensors.  Writes, for each case, rank 0's counters of both partitioned runs
(FLOPs, bytes, peak and argument bytes, collectives by kind and axis) and
the three runs' outputs (the train step's loss and MoE aux loss, the decode
step's logits and updated cache), and the assignments the one-device step's
MoE layers drop.
RMSNorm takes its plain forward on meta tensors too (as it does on CPU
tensors), so both partitioned runs count the same ops:

    PYTHONPATH=src python tests/torch_partition_run.py OUT.json
"""

import contextlib
import dataclasses
import json
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import training
from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, fake_group, make_mesh
from repro_torch.models import moe
from repro_torch.models.params import tree_map

# case → (arch, config overrides, step kinds).  "heads": 4 query / 4 K/V
# heads, split over the tensor axis (the decode cache over its heads);
# "context": 3 query heads, which it does not divide, so the query rows are
# split (the reference's context sharding), and one K/V head, so the decode
# cache is split over its sequence (split-KV); "moe": 8 experts, top 2, at a
# capacity factor of 1 (the train step drops assignments), 4 experts a rank;
# "rwkv6": 4 heads, 2 a rank; "hybrid": recurrentgemma's rglru, rglru,
# local_attn group (3 layers: fewer would leave out its attention), train
# only (its decode was partitioned before these rules).
CASES = {
    "heads": ("phi4-mini-3.8b", {}, ("train", "decode")),
    "context": ("phi4-mini-3.8b", {"n_heads": 3, "n_kv_heads": 1}, ("train", "decode")),
    "moe": ("olmoe-1b-7b", {"n_experts": 8, "top_k": 2, "capacity_factor": 1.0},
            ("train", "decode")),
    "rwkv6": ("rwkv6-1.6b", {}, ("train", "decode")),
    "hybrid": ("recurrentgemma-9b", {"n_layers": 3}, ("train",)),
}
SHAPE = dict(seq_len=32, global_batch=4)
MESH = ((2, 2), ("data", "model"))
WORLD = 4


def steps():
    """Every (case, kind) the runs take."""
    return [(case, kind) for case, (_, _, kinds) in CASES.items() for kind in kinds]


def config(case):
    arch, overrides, _ = CASES[case]
    return reduced_config(arch, remat=True, **dict({"n_layers": 2}, **overrides))


def plan(case, kind, device="meta"):
    mesh = make_mesh(*MESH, devices="meta")
    return dryrun.lower_cell(CASES[case][0], ShapeSpec("t", kind=kind, **SHAPE), mesh,
                             cfg=config(case))


def real_args(p):
    """The plan's arguments as seeded CPU tensors (tokens and targets within
    the vocabulary, a quarter of the targets masked)."""
    from repro_torch.models.model import build_model

    model = build_model(p.cfg)
    g = torch.Generator().manual_seed(1)
    v = p.cfg.vocab_size
    if p.kind == "train":
        state = training.init_train_state(model, 0, device="cpu")
        tokens = torch.randint(0, v, p.args[1]["tokens"].shape, generator=g, dtype=torch.int32)
        targets = torch.randint(0, v, tokens.shape, generator=g, dtype=torch.int32)
        targets[torch.rand(tokens.shape, generator=g) < 0.25] = -1
        return (state, {"tokens": tokens, "targets": targets})
    params = model.init(0, device="cpu")
    cache = tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype), p.args[1])
    tokens = torch.randint(0, v, p.args[2].shape, generator=g, dtype=torch.int32)
    return (params, cache, tokens, torch.zeros((), dtype=torch.int32))


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().double()


def output(p, out):
    """The step's loss (train) or logits (decode) as a nested list."""
    return _whole(out[1]["loss"] if p.kind == "train" else out[0]).tolist()


def aux(p, out):
    """The train step's MoE aux loss (None for a decode step)."""
    return float(_whole(out[1]["aux"])) if p.kind == "train" else None


def cache(p, out):
    """The decode step's updated cache, every leaf flattened into one list
    (None for a train step)."""
    if p.kind != "decode":
        return None
    return torch.cat([_whole(t).flatten() for t in dryrun.tree_tensors(out[1])]).tolist()


@contextlib.contextmanager
def _dropped():
    """The assignments the MoE layers drop (past their capacity), a count a
    layer call."""
    seen, inner = [], moe.assignments

    def counted(*a, **k):
        rank, keep, order = inner(*a, **k)
        seen.append(int((~keep).sum()))
        return rank, keep, order

    moe.assignments = counted
    try:
        yield seen
    finally:
        moe.assignments = inner


def counts(c):
    return {"flops": c["flops"], "bytes": c["bytes"], "peak": c["peak"],
            "arg_live": c["arg_live"],
            "collectives": {f"{k}/{a}": n for (k, a), n in sorted(c["collectives"].items())}}


def _plain_rmsnorm():
    rms_ops._forward = lambda x, scale, eps: rmsnorm_ref(x, scale, eps)


_LIB = None


def _synchronous_collectives():
    """CPU kernels for the functional collectives that hand gloo copies and
    return a tensor gloo never held.  Gloo's worker thread drops its
    reference to a collective's tensors a moment after the work completes;
    where that reference is the last, the storage is freed late, at a time
    that depends on the thread's scheduling, and so would the measured peak
    be.  Here the step's own tensors are freed where the step drops them, as
    in the fake group.  The kernels run under the counters' mode, which sees
    the collective op and none of the copies."""
    global _LIB
    from torch.distributed.distributed_c10d import _resolve_process_group as group

    op = lambda name: getattr(dist.ReduceOp, name.upper())

    def all_reduce(x, reduce_op, name):
        tmp = x.clone()
        dist.all_reduce(tmp, op=op(reduce_op), group=group(name))
        return tmp.clone()

    def all_gather_into_tensor(x, n, name):
        tmp = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(tmp, x.clone(), group=group(name))
        return tmp.clone()

    def reduce_scatter_tensor(x, reduce_op, n, name):
        tmp = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(tmp, x.clone(), op=op(reduce_op), group=group(name))
        return tmp.clone()

    def all_to_all_single(x, out_sizes, in_sizes, name):
        tmp = x.new_empty((sum(out_sizes) if out_sizes else x.shape[0],) + tuple(x.shape[1:]))
        dist.all_to_all_single(tmp, x.clone(), list(out_sizes) or None, list(in_sizes) or None,
                               group=group(name))
        return tmp.clone()

    _LIB = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_reduce, all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single):
        _LIB.impl(fn.__name__, fn, "CPU")


def _rank(rank, port, out_dir):
    torch.set_num_threads(1)
    _plain_rmsnorm()
    _synchronous_collectives()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        result = {}
        dmesh = device_mesh(make_mesh(*MESH, devices="meta"), "cpu")
        for case, kind in steps():
            p = plan(case, kind)
            c = dryrun.step_costs(dryrun.partition(
                dataclasses.replace(p, args=real_args(p)), dmesh))
            result[f"{case}/{kind}"] = {"counts": counts(c), "output": output(p, c["outputs"]),
                                        "aux": aux(p, c["outputs"]),
                                        "cache": cache(p, c["outputs"])}
        if rank == 0:
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def main(out_path):
    torch.set_num_threads(1)
    _plain_rmsnorm()
    result = {}
    with fake_group(WORLD):
        dmesh = device_mesh(make_mesh(*MESH, devices="meta"), "cpu")
        for case, kind in steps():
            result[f"{case}/{kind}"] = {
                "fake": counts(dryrun.step_costs(dryrun.partition(plan(case, kind), dmesh)))}
    for case, kind in steps():
        p = plan(case, kind)
        with _dropped() as dropped:
            out = p.step(*real_args(p))
        result[f"{case}/{kind}"].update(single=output(p, out), aux=aux(p, out),
                                        cache=cache(p, out), dropped=sum(dropped))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = os.path.dirname(os.path.abspath(out_path))
    mp.spawn(_rank, args=(port, out_dir), nprocs=WORLD, join=True)
    with open(os.path.join(out_dir, "rank0.json")) as f:
        for key, real in json.load(f).items():
            result[key]["real"] = real["counts"]
            result[key]["partitioned"] = real["output"]
            result[key]["partitioned_aux"] = real["aux"]
            result[key]["partitioned_cache"] = real["cache"]
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
