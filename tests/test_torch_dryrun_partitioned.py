"""The partitioned dry-run (no card): the TeraAgent step's exchange bytes and
the LM cells' DTensor partition, against the reference and real runs.

* TeraAgent: the reference's ``lower_teraagent`` compiled on 4 and 8 fake
  host devices (a subprocess) moves, kind for kind, the bytes the port's
  records give on both production meshes; the records' bytes are those one
  eager CPU step sends through ``Mesh.shift``, at (2, 2), (4, 4) and
  (2, 2, 2) ranks, a rank.
* The LM partition computed for real: four gloo ranks (a subprocess,
  ``tests/torch_partition_run.py``) run train and decode steps over DTensor
  (dense with heads or query rows split, MoE, rwkv6, recurrentgemma); the
  loss, aux loss, logits and cache equal the single-device step's within
  1e-5, and rank 0's counters equal the fake group's exactly.
* The reference comparison: ``tests/test_dryrun_small.py``'s config and a
  small MoE on (4, 4), the argument bytes equal to the reference's compile;
  the collectives and temp bytes are recorded beside the reference's (each
  partitioner picks its own collectives).
* The CLI over every arch's reduced config on a (4, 4) mesh (a subprocess)
  partitions every cell.
* The hooks leave plain tensors as they are.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread)
from repro_torch import sharding as sh
from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.core import distributed as dist
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (count_shift_bytes, device_mesh, fake_group, make_mesh,
                                     make_production_mesh)
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

# The reference on 16 fake host devices: TeraAgent's compile at (2, 2) and
# (2, 2, 2), and tests/test_dryrun_small.py's cells on (4, 4), of its config
# and of a small MoE.
_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["DRYRUN_XLA_FLAGS"] = ("--xla_force_host_platform_device_count=16 "
                                 "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, %(src)r)
import repro.launch.dryrun as dr
from repro.configs import reduced_config
from repro.launch.mesh import make_mesh

out = {}
for shape, axes in (((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
    compiled = dr.lower_teraagent(make_mesh(shape, axes)).compile()
    out[f"teraagent/{len(shape)}"] = dr.collective_bytes_from_hlo(
        dr._strip_done_ops(compiled.as_text()))
for arch, cfg in (("gemma-7b", dataclasses.replace(%(small)s)),
                  ("olmoe-1b-7b", dataclasses.replace(%(moe)s))):
    for name in ("train_4k", "decode_32k"):
        compiled = dr.lower_cell(arch, name, make_mesh((4, 4), ("data", "model")), cfg=cfg)
        compiled = compiled.compile()
        mem = compiled.memory_analysis()
        out[f"{arch}/{name}"] = dict(
            argument_bytes=mem.argument_size_in_bytes, temp_bytes=mem.temp_size_in_bytes,
            collectives=dr.collective_bytes_from_hlo(dr._strip_done_ops(compiled.as_text())))
print("RESULT " + json.dumps(out))
"""
# tests/test_dryrun_small.py's config, for both packages, and olmoe at its
# widths with 8 experts (2 a rank of the tensor axis).
_SMALL = ('reduced_config("gemma-7b"), d_model=128, n_heads=8, n_kv_heads=8, head_dim=16, '
          'd_ff=256, vocab_size=2048, n_layers=2, dtype="bfloat16", remat=True, '
          'attention_block_q=512, attention_block_k=1024')
_MOE = _SMALL.replace('"gemma-7b"', '"olmoe-1b-7b"') + ", n_experts=8"


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The reference's compiles, the gloo run and the dry-run CLI over the
    reduced configs on a (4, 4) mesh, started together in three processes;
    each test waits for the one it reads."""
    # One thread a process: the suite's other files run beside these.
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    popen = lambda args: subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True, env=env)
    tmp = tmp_path_factory.mktemp("partition")
    out, records = str(tmp / "run.json"), str(tmp / "records")
    procs = {
        "reference": popen([sys.executable, "-c",
                            _REFERENCE % {"src": SRC, "small": _SMALL, "moe": _MOE}]),
        "run": popen([sys.executable, os.path.join(HERE, "torch_partition_run.py"), out]),
        "cli": popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--reduced",
                      "--mesh-shape", "4x4", "--out", records]),
    }
    results = {}

    def result(name):
        if name not in results:
            stdout, stderr = procs[name].communicate(timeout=400)
            assert procs[name].returncode == 0, stdout[-3000:] + stderr[-3000:]
            if name == "reference":
                line = next(l for l in stdout.splitlines() if l.startswith("RESULT "))
                results[name] = json.loads(line[len("RESULT "):])
            elif name == "run":
                with open(out) as f:
                    results[name] = json.load(f)
            else:
                results[name] = [json.load(open(os.path.join(records, f)))
                                 for f in sorted(os.listdir(records))]
        return results[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _eager_shift_bytes(shape, axes):
    """Bytes each rank sends through ``Mesh.shift`` in one eager CPU step of
    the TeraAgent cell's domain and engine (its halo and migration buffers)
    at a pool of 4,096 agents a rank, 1,000 of them placed a rank."""
    mesh = make_mesh(shape, axes, devices="cpu")
    dcfg, _ = dryrun.teraagent_config(mesh)
    ecfg = dryrun.teraagent_engine(dcfg)
    ranks = mesh.ordered(dcfg.mesh_axes)
    extent = [dcfg.extent * n for n in dcfg.axis_sizes] + [dcfg.extent] * (3 - dcfg.n_decomposed)
    pos = np.random.default_rng(3).uniform(0.0, extent, (1000 * mesh.size, 3))
    state = dist.init_dist_state(dcfg, 4096, pos.astype(np.float32), diameter=1.0)
    with count_shift_bytes() as sent:
        dist.step_ranks(ranks, dist.distributed_scheduler(dcfg, ecfg),
                        dist.unstack_state(state, ranks.devices), 0)
    return sent.ranks()


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_teraagent_bytes_equal_the_reference_and_an_eager_step(background, kind):
    """The record of each production mesh: collective bytes kind for kind as
    the reference's compile at (2, 2) / (2, 2, 2) ranks (2,523,136 and
    3,784,704 collective-permute bytes), each the bytes every rank of an
    eager CPU step sends, at 2 ranks an axis and, single-pod, at (4, 4)."""
    rec = dryrun.run_cell("teraagent", "train_4k", kind, None, verbose=False)
    assert rec["status"] == "ok" and rec["kind"] == "abm_step"
    axes = ("data", "model") if kind == "single" else ("pod", "data", "model")
    assert rec["chips"] == (256 if kind == "single" else 512)
    got = rec["collective_bytes_per_device"]
    assert got["collective-permute"] == got["total"] == (2523136 if kind == "single" else 3784704)
    eager = _eager_shift_bytes((2,) * len(axes), axes)
    assert set(eager.values()) == {got["total"]} and len(eager) == 2 ** len(axes)
    if kind == "single":
        assert set(_eager_shift_bytes((4, 4), axes).values()) == {got["total"]}
    ref = background("reference")[f"teraagent/{len(axes)}"]
    assert {k: int(v) for k, v in ref.items()} == got
    assert rec["bytes_accessed_per_device"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert rec["roofline"]["collective_s"] == got["total"] / dryrun.NETWORK_BW
    assert "rank0/overflowed=False" in rec["reason"]


_STEPS = [("heads", "train"), ("context", "train"), ("heads", "decode"),
          ("context", "decode"), ("moe", "train"), ("moe", "decode"), ("rwkv6", "train"),
          ("rwkv6", "decode"), ("hybrid", "train")]


@pytest.mark.parametrize("case,kind", [pytest.param(c, k, id=f"{k}-{c}") for c, k in _STEPS])
def test_partitioned_step_equals_a_real_run_and_one_device(background, case, kind):
    """Four gloo ranks on (2, 2) (``torch_partition_run.CASES``: phi4-mini
    with its heads or its query rows split, olmoe with 8 experts, rwkv6,
    recurrentgemma's group): the train step's loss and MoE aux loss, and the
    decode step's logits and updated cache, within 1e-5 of the
    single-device step's; rank 0's FLOPs, bytes, peak and argument bytes,
    and its collectives by kind and axis, equal to the fake group's rank 0
    on meta tensors.  The MoE train step drops assignments past its
    capacity."""
    run = background("run")[f"{case}/{kind}"]
    assert run["fake"] == run["real"]
    assert run["real"]["collectives"] and run["real"]["peak"] > run["real"]["arg_live"] > 0
    extra = "aux" if kind == "train" else "cache"
    for got, want in (("partitioned", "single"), (f"partitioned_{extra}", extra)):
        np.testing.assert_allclose(np.array(run[got]), np.array(run[want]), rtol=1e-5, atol=1e-5)
    if case == "moe":
        assert (run["dropped"] > 0) == (kind == "train") and (run["aux"] or 0) >= 0


def _against_the_reference(ref, arch, config):
    """``arch``'s train_4k and decode_32k cells of ``config`` (a
    ``dataclasses.replace`` argument string) on (4, 4): the argument bytes
    a device equal the reference's compile; collectives, temp and peak are
    counted (and compared in PERF.md)."""
    cfg = eval(f"dataclasses.replace({config})")
    mesh = make_mesh((4, 4), ("data", "model"), devices="meta")
    for name in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell(arch, name, "4x4", None, verbose=False, mesh=mesh, cfg=cfg)
        want = ref[f"{arch}/{name}"]
        assert rec["memory"]["argument_bytes"] == want["argument_bytes"], name
        assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["peak_estimate_bytes"] > 0
        assert rec["collective_bytes_per_device"]["total"] > 0
        print(arch, name, "port", rec["collective_bytes_per_device"], rec["memory"]["temp_bytes"],
              "reference", want["collectives"], want["temp_bytes"])


def test_reference_config_on_4x4(background):
    """tests/test_dryrun_small.py's config on (4, 4), against the
    reference's compile (``_against_the_reference``)."""
    _against_the_reference(background("reference"), "gemma-7b", _SMALL)


def test_reference_moe_config_on_4x4(background):
    """olmoe at tests/test_dryrun_small.py's widths, 8 experts, on (4, 4):
    the reference's expert sharding against its compile
    (``_against_the_reference``)."""
    _against_the_reference(background("reference"), "olmoe-1b-7b", _MOE)


def test_cli_partitions_every_reduced_cell(background):
    """``python -m repro_torch.launch.dryrun --all --reduced --mesh-shape
    4x4`` exits 0 and gives every applicable cell of every arch (the reduced
    configs) a partitioned record: temp bytes and collective bytes, and no
    fallback."""
    records = background("cli")
    ok = [r for r in records if r["status"] == "ok"]
    assert len(ok) == 33 and all(r["status"] in ("ok", "skipped") for r in records)
    assert {r["arch"] for r in ok} == set(dryrun.ARCHS) | {"teraagent"}
    for r in ok:
        assert r["chips"] == 16 and r["memory"]["temp_bytes"] > 0, r["arch"]
        assert r["collective_bytes_per_device"]["total"] > 0, (r["arch"], r["shape"])
        assert "not partitioned" not in r.get("reason", "")


def test_extrapolation_equals_a_full_depth_partitioned_count():
    """On a (2, 2) mesh, the g / 2g extrapolation of rank 0's counts equals
    its full-depth counts, collectives kind by kind and axis by axis."""
    cfg = dataclasses.replace(reduced_config("phi4-mini-3.8b"), n_layers=4, remat=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices="meta")
    shape = ShapeSpec("t", 32, 4, "train")
    extra = dryrun.extrapolated_costs("phi4-mini-3.8b", shape, cfg=cfg, mesh=mesh)
    full = dryrun.global_costs("phi4-mini-3.8b", shape, cfg, mesh)
    assert (extra["flops"], extra["bytes"]) == (full["flops"], full["bytes"])
    assert extra["collectives"] == full["collectives"] and full["collectives"]


def _plain_step(model, params, tokens):
    """The loss, every gradient and two decode steps' logits, as bytes."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, {"tokens": tokens, "targets": tokens})[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    out = [loss.detach()] + [g for g in grads if g is not None]
    cache = model.init_cache(tokens.shape[0], 8, device="cpu")
    for pos in range(2):
        out.append(model.decode_step(params, cache, tokens[:, pos:pos + 1], pos)[0])
    return [t.numpy().tobytes() for t in out]


def test_hooks_leave_plain_tensors_unchanged():
    """With every hook set, a plain-tensor step gives the bits of a step
    without hooks (the loss, its gradients, decode logits), for each
    partitioned rule: phi4-mini with its query rows split, olmoe's experts,
    rwkv6's heads and recurrentgemma's recurrence; each helper returns a
    plain tensor itself."""
    x = torch.randn(2, 8, 6)
    for arch, kw in (("phi4-mini-3.8b", dict(n_heads=3, n_kv_heads=1)), ("olmoe-1b-7b", {}),
                     ("rwkv6-1.6b", {}), ("recurrentgemma-9b", dict(n_layers=3))):
        cfg = dataclasses.replace(reduced_config(arch), **kw)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(0))
        want = _plain_step(model, params, tokens)
        with fake_group(4):
            dmesh = device_mesh(make_mesh((2, 2), ("data", "model"), devices="meta"))
            hook = sh.Constraint(dmesh, sh.P("data", "model", None))
            model.residual_sharding = model.context_sharding = model.expert_sharding = hook
            model.weight_gather = sh.gather_weights
            got = _plain_step(model, params, tokens)
            assert hook(x) is x and sh.constrain(hook, x) is x
        assert got == want, arch
    for out in (sh.split_on(x, 0), sh.grad_split_on(x, 0), sh.flattened(x, -1, 2),
                sh.unflattenable(x, -1, 2), sh.grad_placed(x, ())):
        assert out is x
    gathered = sh.gather_weights({"w": x, "b": {"s": x}})
    assert gathered["w"] is x and gathered["b"]["s"] is x and not sh.seq_split(x)


def test_placements_follow_the_spec():
    """A spec entry naming mesh axes is Shard(d) on each, in the mesh's
    order; a spec against the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    axes = ("pod", "data", "model")
    assert sh.placements(sh.P(("pod", "data"), None, "model"), axes) == (Shard(0), Shard(0),
                                                                          Shard(2))
    assert sh.placements(sh.P(None, "data"), axes) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("data", "pod")), axes)
    spec = sh.P(("pod", "data"), "model")
    with fake_group(8):
        dmesh = device_mesh(make_mesh((2, 2, 2), axes, devices="meta"))
        t = sh.distribute(torch.empty(8, 6, device="meta"), spec, dmesh)
        assert tuple(t.shape) == (8, 6) and tuple(t.to_local().shape) == (2, 3)
    assert make_production_mesh().size == 256
