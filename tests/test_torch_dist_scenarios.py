"""The reference's distributed scenarios (tests/dist_scenarios.py) applied to
the port, in-process: its mesh needs no forced devices.  Each test names
the scenario it ports; the thresholds are the reference's.  The ring shift
of a mesh of one process a rank is held to the in-process mesh's in one
launch of four gloo processes (``tests/torch_dist_process_run.py shifts``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_process_run as P
import torch_dist_reference as R
from torch_parity import CPU

from repro_torch.core import (EngineConfig, ForceParams, Simulation, init_state, make_pool,
                              run, spec_for_space)
from repro_torch.core import distributed as dist
from repro_torch.launch.mesh import (count_shift_bytes, fake_group, make_mesh, one_card_a_rank,
                                     process_mesh)


def _force_only_setup(halo_codec="int16", **over):
    domain, engine, pos = R.force_setup()
    domain = dict(domain, **over)
    dcfg = dist.DomainConfig(**domain, halo_codec=halo_codec)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), **engine)
    mesh = make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=CPU)
    return mesh, dcfg, ecfg, pos


def _run(mesh, dcfg, ecfg, state, n):
    step = dist.make_distributed_step(mesh, dcfg, ecfg)
    for _ in range(n):
        state = step(state)
    return state


def _global_positions(dcfg, state):
    """Global coordinates of the live agents from the stacked local frames."""
    p, a = state.pool.position.numpy(), state.pool.alive.numpy()
    out = []
    for dev in range(p.shape[0]):
        q = p[dev][a[dev]].copy()
        for d, c in enumerate(dcfg.device_coords(dev)):
            q[:, d] += c * dcfg.extent
        out.append(q)
    return np.concatenate(out, axis=0)


def _single_node(pos, n_steps, dt=0.05, force_impl="reference", box=2.0, max_per_cell=32):
    spec = spec_for_space(0.0, 64.0, box, max_per_cell=max_per_cell)
    ecfg = EngineConfig(spec=spec, force_params=ForceParams(), dt=dt, min_bound=0.0,
                        max_bound=64.0, boundary="open", sort_frequency=4,
                        force_impl=force_impl)
    final, _ = run(ecfg, init_state(make_pool(pos.shape[0], pos, diameter=1.6)), n_steps)
    return final.pool.position.numpy()[final.pool.alive.numpy()]


def _nearest(dist_pos, ref):
    d = np.linalg.norm(dist_pos[:, None, :] - ref[None, :, :], axis=-1)
    return float(d.min(axis=1).max()), len(set(d.argmin(axis=1).tolist()))


def _leaves(state):
    from repro_torch.core.slots import tree_map

    out = []
    tree_map(out.append, state)
    return out


def _assert_states_equal(a, b, label):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.numpy().tobytes() == y.numpy().tobytes(), f"{label}: leaf {i} differs"


@pytest.fixture(scope="module")
def relaxed():
    """30 steps of the 4×2 relaxation (int16)."""
    mesh, dcfg, ecfg, pos = _force_only_setup()
    state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    return _run(mesh, dcfg, ecfg, state, 30), pos.shape[0]


def test_agent_conservation(relaxed):
    """scenario_conservation."""
    state, n = relaxed
    assert int(state.pool.alive.sum()) == n
    assert int(state.migrate_overflow.sum()) == 0
    assert int(state.halo_overflow.sum()) == 0


def test_distributed_runs_static_flag_detection(relaxed):
    """scenario_static_flags_distributed: agents go static, dead slots never."""
    state, _ = relaxed
    static, alive = state.pool.static.numpy(), state.pool.alive.numpy()
    assert static.any()
    assert not (static & ~alive).any()


def test_delta_codec_physics_bound():
    """scenario_codec_reduction: int16 < 1e-3, int8 < 2e-2 against "none"."""
    results = {}
    for codec in ("none", "int16", "int8"):
        mesh, dcfg, ecfg, pos = _force_only_setup(codec)
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
        g = _global_positions(dcfg, _run(mesh, dcfg, ecfg, state, 15))
        results[codec] = g[np.lexsort(g.T)]
    assert np.abs(results["int16"] - results["none"]).max() < 1e-3
    assert np.abs(results["int8"] - results["none"]).max() < 2e-2


def test_fused_force_parity_distributed():
    """scenario_fused_parity: clusters on rank corners; the fused cell-list
    pass over the ghost-extended grid against the dense distributed path
    (5e-4, slot-aligned) and the single-node fused engine (1e-3)."""
    mesh, dcfg, ecfg, pos = _force_only_setup()
    rng = np.random.default_rng(3)
    extra = [np.stack([rng.uniform(cx - 1.5, cx + 1.5, 24), rng.uniform(cy - 1.5, cy + 1.5, 24),
                       rng.uniform(4.0, 12.0, 24)], axis=1)
             for cx, cy in [(16.0, 16.0), (32.0, 16.0), (48.0, 16.0)]]
    pos = np.concatenate([pos] + extra).astype(np.float32)
    n = pos.shape[0]
    state0 = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6)
    finals = {}
    for name, cfg in (("dense", ecfg), ("fused", dataclasses.replace(ecfg, force_impl="fused",
                                                                      fused_overflow_fallback=False))):
        s = _run(mesh, dcfg, cfg, state0, 8)
        assert int(s.pool.alive.sum()) == n and int(s.halo_overflow.sum()) == 0, name
        finals[name] = s
    d = (finals["dense"].pool.position - finals["fused"].pool.position).abs().max()
    assert float(d) < 5e-4
    worst, matched = _nearest(_global_positions(dcfg, finals["fused"]),
                              _single_node(pos, 8, force_impl="fused", box=4.0, max_per_cell=48))
    assert worst < 1e-3 and matched == n


def test_fused_dead_agents_distributed():
    """scenario_fused_dead_agents: dead slots stay invisible to the fused
    path as to the dense one."""
    mesh, dcfg, ecfg, pos = _force_only_setup()
    state0 = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    alive = state0.pool.alive.clone()
    alive[:, 3::17] = False
    state0 = dataclasses.replace(state0, pool=state0.pool.replace(alive=alive))
    finals = {}
    for name, cfg in (("dense", ecfg), ("fused", dataclasses.replace(ecfg, force_impl="fused",
                                                                      fused_overflow_fallback=False))):
        s = _run(mesh, dcfg, cfg, state0, 10)
        assert int(s.pool.alive.sum()) == int(alive.sum()), name
        g = _global_positions(dcfg, s)
        finals[name] = g[np.lexsort(g.T)]
    assert np.abs(finals["dense"] - finals["fused"]).max() < 5e-4


def _overcrowded(lo, hi):
    mesh, dcfg, ecfg, pos = _force_only_setup()
    ecfg = dataclasses.replace(ecfg, spec=dcfg.grid_spec(box_size=2.0, max_per_cell=4), dt=0.01)
    blob = np.random.default_rng(9).uniform(lo, hi, (12, 3)).astype(np.float32)
    pos = np.concatenate([pos, blob]).astype(np.float32)
    state0 = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6)
    finals = {name: _run(mesh, dcfg, cfg, state0, 3) for name, cfg in (
        ("dense", ecfg), ("fused_fb", dataclasses.replace(ecfg, force_impl="fused")))}
    return finals


def test_fused_overflow_falls_back_distributed():
    """scenario_fused_overflow_fallback: an overflowing cell of the
    halo-extended grid sends the fused path to the dense fallback exactly."""
    finals = _overcrowded(5.0, 6.5)
    assert torch.equal(finals["dense"].pool.position, finals["fused_fb"].pool.position)


def test_health_attributes_cell_overflow_to_device():
    """scenario_health_cell_overflow: only rank 0 hosts the crowded cell."""
    finals = _overcrowded(4.2, 5.8)
    assert torch.equal(finals["dense"].pool.position, finals["fused_fb"].pool.position)
    for s in finals.values():
        ovf = s.health.cell_overflow_steps.numpy()
        assert ovf[0] == 3 and (ovf[1:] == 0).all(), ovf
        assert int(s.health.nonfinite_agents.sum()) == 0


def test_halo_wire_telemetry():
    """scenario_telemetry: exact cumulative wire bytes (ceil bitmasks) and
    the overflow counter of an undersized halo buffer."""
    h = 4
    mesh, dcfg, ecfg, pos = _force_only_setup(halo_capacity=h)
    state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    state = _run(mesh, dcfg, ecfg, state, 5)
    per_channel = h * 3 * 2 + (h + 7) // 8 + h * 4 + h + (h + 7) // 8
    per_channel_base = h * 3 * 4 + h * 4 + h * 4 + (h + 7) // 8
    channels = dcfg.n_decomposed * 2
    assert (state.halo_payload_bytes.numpy() == 5 * channels * per_channel).all()
    assert (state.halo_baseline_bytes.numpy() == 5 * channels * per_channel_base).all()
    stats = dist.halo_wire_stats(state)
    assert stats["compression_ratio"] > 1.0 and not stats["wrapped"]
    assert int(state.halo_overflow.sum()) > 0
    zero = dist.reset_halo_wire_counters(state)
    assert dist.halo_wire_stats(zero)["compression_ratio"] == 1.0


def test_distributed_candidates_lazy(monkeypatch):
    """scenario_lazy_candidates: the dense candidate tensor is built once a
    rank a step on the dense path and never on the fused path (nor on its
    fallback while no cell overflows)."""
    import repro_torch.core.neighbors as nb

    calls = {"n": 0}
    real = nb.candidate_neighbors_arrays

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(nb, "candidate_neighbors_arrays", counted)
    mesh, dcfg, ecfg, pos = _force_only_setup()
    state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    counts = {}
    for name, cfg in (("fused", dataclasses.replace(ecfg, force_impl="fused",
                                                     fused_overflow_fallback=False)),
                      ("fused_fallback", dataclasses.replace(ecfg, force_impl="fused")),
                      ("dense", ecfg)):
        calls["n"] = 0
        dist.make_distributed_step(mesh, dcfg, cfg)(state)
        counts[name] = calls["n"]
    assert counts == {"fused": 0, "fused_fallback": 0, "dense": dcfg.n_devices}, counts


def test_scheduler_op_sequence_parity():
    """scenario_scheduler_parity: the single-node schedule op for op, with
    migrate + halo_exchange inserted and three ops replaced in place."""
    from repro_torch.core.schedule import Scheduler

    mesh, dcfg, ecfg, pos = _force_only_setup()
    single = [op.name for op in Scheduler.default(ecfg).ordered_ops()]
    sched = dist.distributed_scheduler(dcfg, ecfg)
    names = [op.name for op in sched.ordered_ops()]
    inserted = {"migrate", "halo_exchange"}
    assert [x for x in names if x not in inserted] == single
    assert names.index("sort") < names.index("migrate") < names.index("halo_exchange") \
        < names.index("env_build")
    s_ops = {op.name: op for op in Scheduler.default(ecfg).ops}
    for op in sched.ops:
        if op.name in s_ops:
            so = s_ops[op.name]
            assert (so.phase, so.frequency, so.gate) == (op.phase, op.frequency, op.gate)
        replaced = op.name in inserted | {"env_build", "boundary", "diffusion"}
        assert (op.fn.__module__ == dist.__name__) == replaced, op.name
    assert [op.name for op in sched.ops if op.collective] == [
        "migrate", "halo_exchange", "diffusion"]
    with pytest.raises(ValueError, match="collective"):
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos)
        sched.step(dist.unstack_state(state, mesh.devices)[0])


def test_multipod_3d_decomposition():
    """scenario_multipod: a (2, 2, 2) mesh decomposing all three dims, its
    ranks numbered in the DomainConfig's axis order."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=CPU)
    dcfg = dist.DomainConfig(mesh_axes=("data", "model", "pod"), axis_sizes=(2, 2, 2),
                             extent=16.0, halo_width=2.0, halo_capacity=96,
                             migrate_capacity=48)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), dt=0.05, min_bound=0.0, max_bound=16.0,
                        sort_frequency=4)
    pos = np.random.default_rng(7).uniform(0.5, 31.5, (400, 3)).astype(np.float32)
    state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    state = _run(mesh, dcfg, ecfg, state, 20)
    assert int(state.pool.alive.sum()) == 400
    assert int(state.migrate_overflow.sum()) == 0


def test_distributed_honors_engine_bounds():
    """scenario_bounds_honored: 'closed' clips the non-decomposed z to
    [min_bound, max_bound], 'open' leaves an escaped agent alone."""
    mesh, dcfg, ecfg, pos = _force_only_setup()
    pos = pos[:32].copy()
    pos[0, 2] = 15.5
    state0 = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    z = {}
    for mode in ("closed", "open"):
        cfg = dataclasses.replace(ecfg, force_params=None, boundary=mode, min_bound=0.0,
                                  max_bound=12.0)
        s = dist.make_distributed_step(mesh, dcfg, cfg)(state0)
        z[mode] = s.pool.position[..., 2][s.pool.alive]
    assert float(z["closed"].max()) <= 12.0 + 1e-6
    assert float(z["open"].max()) > 12.0


def test_facade_distributed_parity():
    """scenario_facade_parity: Simulation.distribute compiles onto the
    explicit wiring bit for bit on a 2×2 mesh, and splits substances."""
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=16.0, halo_width=2.0,
                  halo_capacity=96, migrate_capacity=48, depth=32.0, halo_codec="int16")
    dcfg = dist.DomainConfig(**domain)
    mesh = make_mesh((2, 2), ("data", "model"), devices=CPU)
    pos = np.random.default_rng(11).uniform(1.0, 31.0, (300, 3)).astype(np.float32)
    sim = (Simulation(space=(0.0, 32.0), cell_size=2.0, boundary="open", dt=0.05,
                      max_per_cell=32, seed=3, sort_frequency=4, device=CPU)
           .add_agents(300, position=pos, diameter=1.6)
           .mechanics(ForceParams()))
    dsim = sim.distribute(mesh, dcfg, capacity=256)
    f_state, _ = dsim.run(12)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), dt=0.05, min_bound=0.0, max_bound=32.0,
                        boundary="open", sort_frequency=4)
    assert dsim.config == ecfg
    h_state = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6, seed=3)
    h_state = _run(mesh, dcfg, ecfg, h_state, 12)
    _assert_states_equal(f_state, h_state, "facade")
    assert int(f_state.pool.alive.sum()) == 300

    sim2 = (Simulation(space=(0.0, 32.0), cell_size=2.0, boundary="open", dt=0.05,
                       max_per_cell=32, sort_frequency=4, device=CPU)
            .add_agents(300, position=pos, diameter=1.6)
            .add_substance("cue", diffusion=0.5, resolution=16)
            .mechanics(ForceParams()))
    dsim2 = sim2.distribute(mesh, dcfg, capacity=256)
    assert tuple(dsim2.state.grids["cue"].concentration.shape) == (4, 8, 8, 16)
    s2, _ = dsim2.run(2)
    assert bool(torch.isfinite(s2.grids["cue"].concentration).all())
    with pytest.raises(ValueError, match="halo_width"):
        sim.distribute(mesh, dataclasses.replace(dcfg, halo_width=1.0))
    with pytest.raises(ValueError, match="tile"):
        sim.distribute(mesh, dataclasses.replace(dcfg, extent=8.0))


def _overlap_setup(halo_capacity=96):
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=16.0, halo_width=2.0,
                  halo_capacity=halo_capacity, migrate_capacity=48, depth=32.0,
                  halo_codec="int16")
    dcfg = dist.DomainConfig(**domain)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), dt=0.05, min_bound=0.0, max_bound=32.0,
                        boundary="open", sort_frequency=4)
    rng = np.random.default_rng(21)
    pos = rng.uniform(1.0, 31.0, (300, 3))
    blobs = [rng.uniform([15.0, 1.0, 4.0], [17.0, 31.0, 12.0], (40, 3)),
             rng.uniform([1.0, 15.0, 4.0], [31.0, 17.0, 12.0], (40, 3)),
             rng.uniform([15.2, 15.2, 4.0], [16.8, 16.8, 12.0], (20, 3))]
    pos = np.concatenate([pos] + blobs).astype(np.float32)
    return make_mesh((2, 2), ("data", "model"), devices=CPU), dcfg, ecfg, pos


def _run_pair(mesh, dcfg, ecfg, pos, n_steps):
    state0 = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6)
    return [_run(mesh, d, ecfg, state0, n_steps)
            for d in (dcfg, dataclasses.replace(dcfg, overlap_halo=True))]


@pytest.mark.parametrize("variant", ["dense", "fused_morton", "halo_overflow"])
def test_overlap_schedule_bit_exact(variant):
    """scenario_overlap_parity: the overlapped schedule (interior pass over a
    local-only index, shell pass over the ghost-extended one) equals the
    serial schedule in every leaf."""
    mesh, dcfg, ecfg, pos = _overlap_setup(8 if variant == "halo_overflow" else 96)
    if variant == "fused_morton":
        ecfg = dataclasses.replace(ecfg, force_impl="fused", tile_order="morton")
    serial, overlap = _run_pair(mesh, dcfg, ecfg, pos, 6 if variant == "halo_overflow" else 12)
    if variant == "halo_overflow":
        assert int(serial.halo_overflow.sum()) > 0
    else:
        assert int(serial.pool.alive.sum()) == pos.shape[0]
    _assert_states_equal(serial, overlap, variant)
    names = [op.name for op in dist.distributed_scheduler(
        dataclasses.replace(dcfg, overlap_halo=True), ecfg).ordered_ops()]
    assert names.index("migrate") < names.index("interior_env_build") \
        < names.index("halo_exchange") < names.index("env_build")
    assert names.index("interior_forces") < names.index("shell_forces")
    assert "forces" not in names


def test_distributed_diffusion_edge_parity():
    """scenario_diffusion_edge_parity: a non-toroidal boundary gives the
    mesh-edge ranks zero outside (the single-node field); toroidal wraps."""
    domain, space, res, _, pos = R.diffuse_setup()
    res = 16
    field = np.random.default_rng(4).uniform(0.0, 1.0, (res,) * 3).astype(np.float32)
    dcfg = dist.DomainConfig(**domain)
    mesh = make_mesh((2, 2), ("data", "model"), devices=CPU)

    def build(boundary):
        return (Simulation(space=(0.0, space), cell_size=2.0, boundary=boundary, dt=0.05,
                           max_per_cell=32, capacity=16, device=CPU)
                .add_agents(position=pos, diameter=1.6)
                .add_substance("s", diffusion=1.0, resolution=res, concentration=field))

    single, _ = build("open").run(10)
    ref = single.grids["s"].concentration.numpy()

    def reassemble(stacked):
        out = np.zeros((res,) * 3, np.float32)
        h = res // 2
        for dev in range(4):
            cx, cy = divmod(dev, 2)
            out[cx * h:(cx + 1) * h, cy * h:(cy + 1) * h] = stacked[dev]
        return out

    got = reassemble(build("open").distribute(mesh, dcfg).run(10)[0]
                     .grids["s"].concentration.numpy())
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=1e-6)
    tor = reassemble(build("toroidal").distribute(mesh, dcfg).run(10)[0]
                     .grids["s"].concentration.numpy())
    assert np.abs(tor[0] - ref[0]).max() > 1e-4


def test_interior_shell_masks_partition_live_cells():
    """test_distributed.py's interior/shell partition, on the port."""
    dcfg = dist.DomainConfig(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=16.0,
                             halo_width=2.0, halo_capacity=32, migrate_capacity=16, depth=32.0)
    box = 2.0
    spec = dcfg.grid_spec(box_size=box, max_per_cell=32)
    rng = np.random.default_rng(6)
    pos = rng.uniform(-2.0, 18.0, (512, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(0.0, 32.0, 512)
    alive = rng.random(512) < 0.8
    interior, shell = dist.interior_shell_masks(dcfg, spec, torch.from_numpy(pos),
                                                torch.from_numpy(alive))
    interior, shell = interior.numpy(), shell.numpy()
    assert not (interior & shell).any()
    np.testing.assert_array_equal(interior | shell, alive)
    for d in range(2):
        c = pos[interior, d]
        assert (c >= box).all() and (c <= 16.0 - box).all()
    deep = alive & (pos[:, :2] >= 2 * box).all(axis=1) & (pos[:, :2] < 16.0 - 2 * box).all(axis=1)
    assert deep.any() and interior[deep].all()
    outside = alive & ((pos[:, :2] < 0) | (pos[:, :2] >= 16.0)).any(axis=1)
    assert shell[outside].all()


def test_mesh_shift_and_axis_index():
    """The ring shift of launch/mesh.py: sizes 1 and 2 (where +1 and −1 reach
    the same neighbour) and a 3-long axis; ranks renumbered by ``ordered``."""
    mesh = make_mesh((2, 3), ("a", "b"), devices=CPU)
    vals = [torch.tensor([r]) for r in range(6)]
    got = [int(v) for v in mesh.shift(vals, "b", +1)]
    assert got == [2, 0, 1, 5, 3, 4]
    assert [int(v) for v in mesh.shift(vals, "b", -1)] == [1, 2, 0, 4, 5, 3]
    assert [int(v) for v in mesh.shift(vals, "a", +1)] == [3, 4, 5, 0, 1, 2]
    assert [int(v) for v in mesh.shift(vals, "a", -1)] == [3, 4, 5, 0, 1, 2]
    assert [mesh.axis_index(r, "b") for r in range(6)] == [0, 1, 2, 0, 1, 2]
    one = make_mesh((1, 2), ("x", "y"), devices=CPU)
    assert [int(v) for v in one.shift(vals[:2], "x", +1)] == [0, 1]
    flipped = mesh.ordered(("b", "a"))
    assert flipped.axis_sizes == (3, 2)
    assert [flipped.axis_index(r, "a") for r in range(6)] == [0, 1, 0, 1, 0, 1]
    with pytest.raises(ValueError):
        mesh.ordered(("a",))


# ------------------------------------------------------- one process a rank


@pytest.fixture(scope="module")
def shifts(tmp_path_factory):
    """Four gloo processes' shifts and step bytes on (2, 2) and (4, 1), and
    a launch of three in which rank 1 fails."""
    out = str(tmp_path_factory.mktemp("dist_shifts") / "shifts.npz")
    here = os.path.dirname(__file__)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(here, "torch_dist_process_run.py"),
                           "shifts", out], capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-8000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _in_process_shift(shape, axis, direction):
    mesh = make_mesh(shape, ("a", "b"), devices=CPU)
    return [int(v) for v in mesh.shift([torch.tensor(r) for r in range(mesh.size)], axis,
                                       direction)]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_process_mesh_shift_matches_in_process(shifts, shape):
    """``Mesh.shift`` with one process a rank: ±1 along both axes, every
    leaf of the value (int32, bool, f32, int8) from the in-process mesh's
    sender.  On (2, 2) both directions reach the same process; on (4, 1) the
    1-long axis is the identity (the value itself, nothing sent)."""
    tag = "x".join(map(str, shape))
    for axis in ("a", "b"):
        for direction in (1, -1):
            senders = _in_process_shift(shape, axis, direction)
            for r in range(4):
                key = f"rank{r}/{tag}/{axis}/{direction:+d}"
                src = senders[r]
                np.testing.assert_array_equal(shifts[f"{key}/rank"], [src, 100 + src])
                np.testing.assert_array_equal(shifts[f"{key}/flag"], [src % 2 == 0])
                np.testing.assert_array_equal(shifts[f"{key}/pos"], np.full((3, 3), float(src)))
                assert shifts[f"{key}/kind"].dtype == np.int8 and int(shifts[f"{key}/kind"]) == src
                assert bool(shifts[f"{key}/same_object"]) == (shape[("a", "b").index(axis)] == 1)
    if shape == (2, 2):
        assert _in_process_shift(shape, "a", 1) == _in_process_shift(shape, "a", -1)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_process_mesh_shift_bytes_equal_in_process(shifts, shape):
    """``count_shift_bytes`` over one distributed step: each process's rank
    sends the in-process mesh's bytes along each axis, and the stepped state
    every process gathers is the in-process step's, bit for bit."""
    tag = "x".join(map(str, shape))
    dcfg, ecfg, pos = P.shift_engine(shape)
    state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
    mesh = make_mesh(shape, ("a", "b"), devices=CPU)
    with count_shift_bytes() as sent:
        stepped = dist.make_distributed_step(mesh, dcfg, ecfg)(state)
    for r in range(4):
        got = {a: int(shifts[f"rank{r}/{tag}/bytes/{a}"]) for a in ("a", "b")
               if f"rank{r}/{tag}/bytes/{a}" in shifts}
        assert got == sent.on_axes(r) and min(got.values()) > 0, (r, got, sent.on_axes(r))
        np.testing.assert_array_equal(shifts[f"rank{r}/{tag}/senders"], [r])
        assert str(shifts[f"rank{r}/{tag}/step_digest"]) == P.digest(stepped)


def test_process_launch_fails_at_the_first_failed_rank(shifts):
    """``launch.procs.spawn``: a rank that raises fails the launch, named,
    within seconds; the ranks waiting on it are stopped, not left hanging."""
    message = str(shifts["failure/message"])
    assert message.startswith("procs: rank 1 failed first: RuntimeError: a planned failure")
    assert float(shifts["failure/seconds"]) < 30


def test_process_mesh_refusals():
    """No silent fallback: a process mesh without a process group, of the
    wrong size, or on the card where there is none raises; NCCL with two
    ranks on one card raises."""
    with pytest.raises(RuntimeError, match="no process group"):
        process_mesh((2, 2), ("data", "model"), devices="cpu")
    with fake_group(8, rank=3):
        with pytest.raises(ValueError, match="8 processes"):
            process_mesh((2, 2), ("data", "model"), devices="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                process_mesh((4, 2), ("data", "model"))
        mesh = process_mesh((4, 2), ("data", "model"), devices="cpu")
        assert mesh.local_ranks == (3,) and mesh.device == CPU
    one_card_a_rank([("h", "GPU-0"), ("h", "GPU-1"), ("g", "GPU-0")])
    with pytest.raises(ValueError, match="NCCL takes one rank a card"):
        one_card_a_rank([("h", "GPU-0"), ("h", "GPU-1"), ("h", "GPU-0")])
