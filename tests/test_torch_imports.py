"""The port stands alone: no JAX, nothing of ``repro``, no silent fallback."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_slice.py",
    ROOT / "scripts" / "flash_sharp_softmax.py", ROOT / "scripts" / "time_flash_trees.py",
    ROOT / "scripts" / "ablate_flash_d256.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "from repro_torch import Simulation\n"
        "import repro_torch.kernels.cell_rank, repro_torch.kernels.cell_force\n"
        "import repro_torch.kernels.diffusion3d, repro_torch.kernels.pairwise_force\n"
        "import repro_torch.kernels.rmsnorm, repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs, repro_torch.models.model, repro_torch.training\n"
        "import repro_torch.launch.serve, repro_torch.launch.elastic\n"
        "import repro_torch.launch.abm_serve, repro_torch.core.batch\n"
        "import repro_torch.core.slots, repro_torch.checkpoint\n"
        "import repro_torch.core.distributed, repro_torch.core.delta\n"
        "import repro_torch.launch.mesh, repro_torch.optim.pso\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
        "import repro_torch.data, repro_torch.launch.train\n"
        "import repro_torch.kernels.flash_attention.chunked_vjp\n"
        "import repro_torch.sharding, repro_torch.configs.shapes\n"
        "import repro_torch.launch.dryrun, repro_torch.core.runner\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_resolve_device_raises_without_a_card(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from repro_torch import Simulation

        Simulation(space=10.0)


def test_lm_entry_points_take_the_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced_config("phi4-mini-3.8b"))
    for call in (lambda: model.init(0), lambda: model.init(torch.Generator()),
                 lambda: model.init_cache(1, 4), lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = model.init(0, device="cpu")
    cache = model.init_cache(1, 4, "cpu")
    assert {t.device.type for t in tree_leaves(params) + tree_leaves(cache)} == {"cpu"}


def _unknown_impl_calls():
    from repro_torch.core import EngineConfig, ForceParams, diffuse, make_grid, spec_for_space
    from repro_torch.core.forces import mechanical_forces
    from repro_torch.kernels.cell_force import ops as cf_ops
    from repro_torch.kernels.cell_rank import ops as cr_ops
    from repro_torch.kernels.diffusion3d import ops as d3_ops
    from repro_torch.kernels.pairwise_force import ops as pf_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model

    spec = spec_for_space(0.0, 10.0, 5.0)
    q4 = torch.zeros((1, 1, 2, 16))
    u = torch.zeros((2, 2, 2))
    cid = torch.zeros((3,), dtype=torch.int32)
    pos = torch.zeros((1, 3))
    return {
        "cell_rank": lambda: cr_ops.cell_rank(cid, 8, impl="xla"),
        "cell_list_force": lambda: cf_ops.cell_list_force(
            pos, torch.ones(1), torch.ones((1, 4), dtype=torch.int32), (1, 1, 1),
            impl="pallas"),
        "diffusion_step": lambda: d3_ops.diffusion_step(u, 0.1, impl="pallas"),
        "diffuse": lambda: diffuse(make_grid(0.0, 1.0, 2, 0.1), 1.0, impl="pallas"),
        "rank_impl": lambda: spec_for_space(0.0, 10.0, 5.0, rank_impl="xla"),
        "force_impl": lambda: EngineConfig(spec=spec, force_impl="refrence"),
        "diffusion_impl": lambda: EngineConfig(spec=spec, diffusion_impl="fused"),
        "tile_order": lambda: EngineConfig(spec=spec, tile_order="hilbert"),
        "boundary": lambda: EngineConfig(spec=spec, boundary="wrap"),
        "mechanical_forces": lambda: mechanical_forces(
            spec, None, None, ForceParams(), impl="pallas"),
        "cell_window_force": lambda: cf_ops.cell_window_force(
            pos, torch.ones(1), torch.zeros(1, dtype=torch.int32), (1, 1, 1),
            impl="pallas"),
        "pairwise_force": lambda: pf_ops.pairwise_force(
            pos, torch.ones(1), torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.bool), impl="pallas"),
        "force_impl_pallas": lambda: EngineConfig(spec=spec, force_impl="pallas"),
        "rmsnorm": lambda: rms_ops.rmsnorm(pos, torch.ones(3), impl="pallas"),
        "flash_attention": lambda: fa_ops.flash_attention(q4, q4, q4, impl="pallas"),
        "attention_impl": lambda: build_model(
            dataclasses.replace(reduced_config("phi4-mini-3.8b"), attention_impl="pallas")),
    }


@pytest.mark.parametrize("what", sorted(_unknown_impl_calls()))
def test_unknown_impl_raises(what):
    with pytest.raises(ValueError):
        _unknown_impl_calls()[what]()


# Ported in slice 2: the dense pairwise_force kernel (the reference's
# force_impl="pallas") and the Morton-window path now run.
@pytest.mark.parametrize("kw", [
    dict(impl="cuda"),
    dict(impl="fused", tile_order="morton", morton_window=4),
], ids=["force_impl_cuda", "tile_order_morton"])
def test_ported_force_paths_run(kw):
    import numpy as np

    from repro_torch import Simulation
    from repro_torch.core import ForceParams

    pos = np.random.default_rng(0).uniform(20, 30, (40, 3)).astype(np.float32)
    sim = (Simulation(space=50.0, cell_size=5.0, sort_frequency=1, device="cpu")
           .add_agents(position=pos, diameter=4.0)
           .mechanics(ForceParams(), **kw))
    built = sim.build()
    assert built.config.force_impl == kw["impl"]
    assert built.config.tile_order == kw.get("tile_order", "linear")
    final, _ = built.run(2)
    moved = (final.pool.position - built.state.pool.position).abs().amax(dim=1)
    assert bool((moved > 0).any()) and bool(torch.isfinite(final.pool.position).all())


def test_morton_facade_runs_in_a_batch():
    """``tile_order="morton"`` through ``run_batch`` (it raised while the
    window kernel had no slot axis): each slot equals its solo run."""
    import numpy as np

    from repro_torch import Simulation
    from repro_torch.core import prng

    pos = np.random.default_rng(0).uniform(20, 30, (40, 3)).astype(np.float32)
    built = (Simulation(space=50.0, cell_size=5.0, sort_frequency=1, device="cpu")
             .add_agents(position=pos, diameter=4.0)
             .mechanics(impl="fused", tile_order="morton", morton_window=4)).build()
    finals, _ = built.run_batch(2, batch=2)
    for b in range(2):
        key = prng.fold_in(built.state.rng, b)
        solo, _ = built.run(2, state=dataclasses.replace(built.state, rng=key))
        assert torch.equal(finals.pool.position[b], solo.pool.position)
    moved = (finals.pool.position[0] - built.state.pool.position).abs().amax(dim=1)
    assert bool((moved > 0).any()) and bool(torch.isfinite(finals.pool.position).all())
