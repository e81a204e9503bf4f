"""The dry-run's counters and records at reduced configs (no card).

Every comparison here is exact (integer FLOPs, bytes and byte counts, or
shapes): the g / 2g-layer extrapolation against a direct full-depth count on
meta; the meta run's FLOP count, bytes and live-storage peak against the
same counters over a real CPU run of the same step; the visible-tile count
against a brute-force mask; the kernels' meta stand-ins against their
outputs' shapes; the records' keys against the reference's.
"""

import dataclasses
import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

import torch_parity  # noqa: F401  (one intra-op thread)
from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa_k
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import visible
from repro_torch.kernels.rmsnorm import kernel as rms_k
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.params import tree_map

ONE = make_mesh((1, 1), ("data", "model"), devices="meta")

# The reference's record keys (repro/launch/dryrun.py run_cell), "reason"
# being its skip records'.
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "status", "lower_s", "compile_s",
               "flops_per_device", "bytes_accessed_per_device", "collective_bytes_per_device",
               "memory", "roofline", "model_flops_per_device", "useful_flops_fraction", "reason"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_estimate_bytes"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "memory_s_fused_est", "collective_s", "dominant"}


def small(arch, groups=4, **kw):
    """``reduced_config(arch)`` at ``groups`` pattern groups (an
    encoder–decoder with as many encoder layers)."""
    cfg = reduced_config(arch, **kw)
    n = groups * len(cfg.block_pattern)
    return dataclasses.replace(cfg, n_layers=n,
                               n_encoder_layers=n if cfg.is_encoder_decoder else 0)


CASES = [  # (arch, attention impl)
    ("phi4-mini-3.8b", "cuda"),      # dense; the flash kernel's meta stand-in
    ("olmoe-1b-7b", "chunked"),      # MoE
    ("recurrentgemma-9b", "cuda"),   # recurrent (rglru) + local attention, g = 3
    ("rwkv6-1.6b", "chunked"),       # recurrent (rwkv6)
    ("whisper-base", "cuda"),        # encoder–decoder
]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_extrapolation_equals_a_full_depth_count(arch, impl, kind):
    """``extrapolated_costs`` (L = g and 2g, then A + (L − g)/g · (B − A))
    equals one meta run at full depth, FLOPs and bytes exactly."""
    cfg = dataclasses.replace(small(arch), attention_impl=impl, remat=True)
    shape = ShapeSpec("t", 48, 2, kind)
    direct = dryrun.step_costs(dryrun.lower_cell(arch, shape, ONE, cfg=cfg))
    extra = dryrun.extrapolated_costs(arch, shape, cfg=cfg)
    assert extra["flops"] == direct["flops"] and extra["bytes"] == direct["bytes"]
    assert extra["shallow_b"]["flops"] > extra["shallow_a"]["flops"] > 0


def _real(plan, vocab):
    """The plan's arguments as CPU tensors (tokens within the vocabulary)."""
    g = torch.Generator().manual_seed(0)

    def one(t):
        if t.dtype == torch.int32:
            return torch.randint(0, vocab, t.shape, generator=g, dtype=torch.int32)
        return torch.randn(t.shape, generator=g).to(t.dtype)

    return tuple(tree_map(one, a) for a in plan.args)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "olmoe-1b-7b", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "whisper-base", "paligemma-3b"])
def test_meta_counters_equal_a_cpu_run(monkeypatch, arch, kind):
    """The same step on meta and on the CPU: FLOPs, bytes, the arguments'
    and the peak live storage bytes equal.  Both run the plain versions (the
    ``"chunked"`` attention; RMSNorm's plain forward, which CPU tensors take
    and which meta tensors take here too, where they would otherwise take the
    kernel's stand-in)."""
    monkeypatch.setattr(rms_ops, "_forward", lambda x, s, eps: rmsnorm_ref(x, s, eps))
    cfg = dataclasses.replace(small(arch, groups=2), remat=True)
    plan = dryrun.lower_cell(arch, ShapeSpec("t", 32, 2, kind), ONE, cfg=cfg)
    meta = dryrun.step_costs(plan)
    cpu = dryrun.step_costs(dataclasses.replace(plan, args=_real(plan, cfg.vocab_size)))
    for k in ("flops", "bytes", "peak", "arg_live"):
        assert meta[k] == cpu[k], k
    assert meta["peak"] > meta["arg_live"] > 0


def test_one_device_record_has_the_temp_and_peak_of_a_full_run():
    cfg = dataclasses.replace(small("phi4-mini-3.8b", groups=3), attention_impl="cuda")
    shape = ShapeSpec("t", 64, 2, "train")
    rec = dryrun.run_cell("phi4-mini-3.8b", shape, "one", None, verbose=False, mesh=ONE, cfg=cfg)
    full = dryrun.step_costs(dryrun.lower_cell("phi4-mini-3.8b", shape, ONE, cfg=cfg))
    mem = rec["memory"]
    assert rec["flops_per_device"] == full["flops"]
    assert mem["temp_bytes"] == full["peak"] - full["arg_live"]
    assert mem["alias_bytes"] == mem["output_bytes"] - 7 * 4  # the state; 7 f32 metrics
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                          + mem["temp_bytes"] - mem["alias_bytes"])
    assert "visible-tile formula" in rec["reason"]


def test_run_cell_writes_a_record_with_the_reference_keys(tmp_path):
    rec = dryrun.run_cell("whisper-base", "decode_32k", "single", str(tmp_path), verbose=False)
    on_disk = json.loads((tmp_path / "single__whisper-base__decode_32k.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert set(rec) <= RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["reason"].startswith("rank 0's program over a fake process group")
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["peak_estimate_bytes"] > 0
    assert set(rec["collective_bytes_per_device"]) == set(dryrun.COLLECTIVES) | {"total"}
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert rec["roofline"]["collective_s"] > 0 and rec["roofline"]["memory_s_fused_est"] is None
    skip = dryrun.run_cell("whisper-base", "long_500k", "multi", str(tmp_path), verbose=False)
    assert skip["status"] == "skipped" and set(skip) <= RECORD_KEYS


class _LargestCpuTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in dryrun.tree_tensors(out):
            # DTensor's sharding propagation makes fake tensors: no storage.
            if t.device.type != "meta" and not isinstance(t, FakeTensor):
                self.largest = max(self.largest, t.numel() * t.element_size())
        return out


def test_the_dry_run_needs_no_card_and_allocates_nothing(monkeypatch, tmp_path):
    """``make_production_mesh`` and ``run_cell`` at full configs (a train
    step of 16 × 512 tokens, a prefill and a decode cell, and TeraAgent's)
    run on a host without a card (``torch.cuda.is_available()`` False,
    ``device_count()`` 0: DTensor's sharding propagation asks, in its fake
    mode and its redistribution costs), make no other CUDA call and no
    tensor off the meta device larger than the
    partitioned cells' device mesh's rank table (``DeviceMesh`` keeps one
    int64 a rank on the host); TeraAgent's step none larger than its grid's
    Morton rank table (one int32 a cell, built on the host and moved to the
    device once, ``grid.device_constant``).  TeraAgent's branches are
    recorded by an eager CPU step (``teraagent_branches``), left out of the
    count."""
    def no_card(*a, **k):
        raise AssertionError("the dry-run called CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for name in ("init", "synchronize", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    record = dryrun.teraagent_branches

    def uncounted(*a, **k):
        with _disable_current_modes():
            return record(*a, **k)

    monkeypatch.setattr(dryrun, "teraagent_branches", uncounted)
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.size == 512 and {d.type for d in mesh.devices} == {"meta"}
    cells = (("whisper-base", ShapeSpec("t", 512, 16, "train")), ("gemma-7b", "prefill_32k"),
             ("recurrentgemma-9b", "long_500k"), ("teraagent", "train_4k"))
    dcfg, _ = dryrun.teraagent_config(dryrun.stepped_mesh(mesh))
    n_cells = dryrun.teraagent_engine(dcfg).spec.n_cells
    for (arch, shape), bound in zip(cells, (8 * mesh.size,) * 3 + (4 * (n_cells + 1),)):
        spy = _LargestCpuTensor()
        with spy:
            rec = dryrun.run_cell(arch, shape, "multi", str(tmp_path), verbose=False)
        assert rec["status"] == "ok" and rec["memory"]["argument_bytes"] > 0
        assert spy.largest <= bound, arch


def test_cli_runs_one_cell(tmp_path, capsys):
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "single__rwkv6-1.6b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert "All dry-run cells passed." in capsys.readouterr().out


@pytest.mark.parametrize("tq,tk,causal,window,prefix,offset", [
    (200, 200, True, None, 0, 0), (256, 256, False, None, 0, 0), (300, 300, True, 70, 0, 0),
    (130, 130, True, None, 40, 0), (17, 150, True, None, 0, 133), (64, 500, False, None, 0, 0),
])
def test_visible_tiles_equal_a_brute_force_count(tq, tk, causal, window, prefix, offset):
    """The 64 × 64 tiles holding a visible pair, against the mask itself."""
    t = dryrun.FLASH_TILE
    vis = visible(torch.arange(tq)[:, None] + offset, torch.arange(tk)[None, :], causal, window,
                  prefix)
    vis = torch.nn.functional.pad(vis, (0, -tk % t, 0, -tq % t))
    want = int(vis.reshape(vis.shape[0] // t, t, vis.shape[1] // t, t).any(3).any(1).sum())
    assert dryrun.visible_tiles(tq, tk, causal, window, prefix, offset) == want
    assert dryrun.flash_attention_flops((2, 4, tq, 64), (2, 2, tk, 64), causal, window, prefix,
                                        offset) == 4 * 64 * want * t * t * 2 * 4


def test_kernel_stand_ins_on_meta_launch_nothing():
    """On meta tensors the flash and RMSNorm ops return the kernels' outputs
    (shapes, dtypes) without a launch, in the serving path and through the
    autograd Functions (the backward runs on meta too); the observers see
    each flash call."""
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    q, k, v = meta(2, 8, 40, 64), meta(2, 2, 40, 64), meta(2, 2, 40, 64)
    before = (fa_k.launches, fa_k.launches_tc, rms_k.launches)
    seen = []
    fa_k.meta_observers.append(lambda *call: seen.append(call))
    try:
        out = fa_ops.flash_attention(q, k, v, causal=True, window=16)
        assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype, "meta")
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = fa_ops.flash_attention(qg, kg, vg, causal=True)
        dq, dk, dv = torch.autograd.grad(out.sum(), (qg, kg, vg))
        assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
        assert dq.device.type == "meta"
    finally:
        fa_k.meta_observers.pop()
    assert seen == [((2, 8, 40, 64), (2, 2, 40, 64), True, 16, 0, 0),
                    ((2, 8, 40, 64), (2, 2, 40, 64), True, None, 0, 0)]
    x, scale = meta(3, 5, 32), meta(32, dt=torch.float32)
    y = rms_ops.rmsnorm(x, scale)
    xg = x.clone().requires_grad_()
    dx, = torch.autograd.grad(rms_ops.rmsnorm(xg, scale).sum(), (xg,))
    assert (y.shape, y.dtype, dx.shape) == (x.shape, x.dtype, x.shape)
    assert (fa_k.launches, fa_k.launches_tc, rms_k.launches) == before
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(meta(1, 1, 8, 48), meta(1, 1, 8, 48), meta(1, 1, 8, 48))


def test_meta_is_taken_only_when_asked(monkeypatch):
    """``resolve_device("meta")`` is the meta device; ``None`` still means the
    card and raises without one; ``Model.init_params`` on meta draws nothing
    and holds the reference's axes."""
    from repro_torch.models.model import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    model = build_model(reduced_config("phi4-mini-3.8b"))
    tree = model.init_params(123, device="meta")
    assert tree["layers"]["b0"]["attn"]["wq"].axes == ("layers", "embed", "heads", "head_dim")
    assert tree["layers"]["b0"]["attn"]["wq"].value.device.type == "meta"
