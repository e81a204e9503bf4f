"""Partitioned LM steps on a (2, 2) mesh, run for real and planned.

Four gloo ranks (processes) run each case's step over DTensor from the
same seeded full tensors; the parent runs rank 0's program over a fake
process group on meta tensors, and the single-device step on the full
tensors.  Writes, for each case, rank 0's counters of both partitioned runs
(FLOPs, bytes, peak and argument bytes, collectives by kind and axis) and
the three runs' outputs (the train step's loss, the decode step's logits).
RMSNorm takes its plain forward on meta tensors too (as it does on CPU
tensors), so both partitioned runs count the same ops:

    PYTHONPATH=src python tests/torch_partition_run.py OUT.json
"""

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
from repro_torch.models.params import tree_map

ARCH = "phi4-mini-3.8b"
# "heads": 4 query / 4 K/V heads, split over the tensor axis (the decode
# cache over its heads); "context": 3 query heads, which it does not divide,
# so the query rows are split (the reference's context sharding), and one
# K/V head, so the decode cache is split over its sequence (split-KV).
CASES = {"heads": {}, "context": {"n_heads": 3, "n_kv_heads": 1}}
KINDS = ("train", "decode")
SHAPE = dict(seq_len=32, global_batch=4)
MESH = ((2, 2), ("data", "model"))
WORLD = 4


def config(case):
    cfg = reduced_config(ARCH, remat=True, **CASES[case])
    return dataclasses.replace(cfg, n_layers=2)


def plan(case, kind, device="meta"):
    mesh = make_mesh(*MESH, devices="meta")
    return dryrun.lower_cell(ARCH, ShapeSpec("t", kind=kind, **SHAPE), mesh, cfg=config(case))


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


def output(p, out):
    """The step's loss (train) or logits (decode) as a nested list."""
    t = out[1]["loss"] if p.kind == "train" else out[0]
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().double().tolist()


def counts(c):
    return {"flops": c["flops"], "bytes": c["bytes"], "peak": c["peak"],
            "arg_live": c["arg_live"],
            "collectives": {f"{k}/{a}": n for (k, a), n in sorted(c["collectives"].items())}}


def _plain_rmsnorm():
    rms_ops._forward = lambda x, scale, eps: rmsnorm_ref(x, scale, eps)


def _rank(rank, port, out_dir):
    torch.set_num_threads(1)
    _plain_rmsnorm()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        result = {}
        dmesh = device_mesh(make_mesh(*MESH, devices="meta"), "cpu")
        for case in CASES:
            for kind in KINDS:
                p = plan(case, kind)
                c = dryrun.step_costs(dryrun.partition(
                    dataclasses.replace(p, args=real_args(p)), dmesh))
                result[f"{case}/{kind}"] = {"counts": counts(c), "output": output(p, c["outputs"])}
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
        for case in CASES:
            for kind in KINDS:
                result[f"{case}/{kind}"] = {
                    "fake": counts(dryrun.step_costs(dryrun.partition(plan(case, kind), dmesh)))}
    for case in CASES:
        for kind in KINDS:
            p = plan(case, kind)
            result[f"{case}/{kind}"]["single"] = output(p, p.step(*real_args(p)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = os.path.dirname(os.path.abspath(out_path))
    mp.spawn(_rank, args=(port, out_dir), nprocs=WORLD, join=True)
    with open(os.path.join(out_dir, "rank0.json")) as f:
        for key, real in json.load(f).items():
            result[key]["real"] = real["counts"]
            result[key]["partitioned"] = real["output"]
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
