"""The distributed engine's compiled run (``DistributedSimulation.run_jit``,
``distributed.jitted_distributed_runner``, ``resume(jit=True)``) against its
eager lock-step ``run`` on the CPU.

On CPU tensors the runner calls each captured step body as a plain function,
so the host count, the keys (the firing pattern and every rank's branches,
each force pass under its own ``rank{r}/`` scope), the device flag and the
rollback all run here.  Every comparison is by bytes: every leaf of the
stacked ``DistState`` and every observable row.  The models are the
reference's distributed test cases (``tests/torch_dist_reference.py``'s
facade-resume model, and ``tests/dist_scenarios.py``'s overlap layout, blobs
on the rank faces and corners); the one-rank flip model (``dist_crowd``) and
the comparison helpers are ``tests/torch_jit_cases.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_reference as R
import torch_jit_cases as J
from torch_parity import CPU

from repro_torch.core import EngineConfig, ForceParams, Simulation
from repro_torch.core import distributed as dist
from repro_torch.launch.mesh import Mesh, make_mesh


def _resume_model(codec="int16", **mechanics):
    """tests/dist_scenarios.py's facade-resume model (200 agents of two kinds
    on a 2x2 mesh) with its kind counts every step and its population every
    third step."""
    domain, space, pos, kinds = R.resume_setup()
    domain = dict(domain, halo_codec=codec)
    sim = (Simulation(space=(0.0, space), cell_size=2.0, boundary="open", dt=0.05,
                      max_per_cell=32, seed=3, sort_frequency=4, capacity=256, device="cpu")
           .add_agents(position=pos, diameter=1.6, kind=kinds)
           .mechanics(ForceParams(), **mechanics)
           .observe_kinds("counts", n_kinds=2)
           .observe("pop3", lambda s: s.pool.alive.sum(dtype=torch.int32), frequency=3))
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"], devices=CPU)
    return sim.distribute(mesh, dist.DomainConfig(**domain))


def _both(dsim, steps, state=None):
    """``run`` and ``run_jit`` from one state, bit for bit equal; returns the
    compiled result and the runner's counts for it."""
    eager = dsim.run(steps, state=state)
    runner = dsim._jitted
    before = dict(runner.stats)
    jit = dsim.run_jit(steps, state=state)
    J.assert_runs_bit_equal(eager, jit)
    return jit, {k: v - before[k] for k, v in runner.stats.items()}


@pytest.mark.parametrize("codec", ["none", "int16", "int8"])
def test_serial_schedule_run_jit_equals_run(codec):
    """The serial schedule under each halo codec, from an odd start (the
    every-third-step series starts off its phase): 8 steps replayed, every
    leaf and row equal to the eager run's."""
    dsim = _resume_model(codec)
    start, _ = dsim.run(1)
    (final, obs), counts = _both(dsim, 8, state=start)
    assert obs["counts"].shape == (8, 2) and obs["pop3"].shape == (2,)
    assert int(final.step[0]) == 9
    assert counts["replays"] >= 8 - counts["eager_steps"] and counts["rollbacks"] == 0
    assert counts["graphs"] >= 2       # the sort fires every fourth step: two keys
    if codec != "none":
        assert int(final.halo_payload_bytes.sum()) > 0


def _overlap_setup():
    """tests/dist_scenarios.py's ``_overlap_setup``: a 2x2 mesh with blobs
    on the rank faces and the corner (real ghosts and migration each step),
    through the overlapped schedule with the fused Morton kernel."""
    domain = dict(mesh_axes=("data", "model"), axis_sizes=(2, 2), extent=16.0,
                  halo_width=2.0, halo_capacity=96, migrate_capacity=48, depth=32.0,
                  halo_codec="int16", overlap_halo=True)
    dcfg = dist.DomainConfig(**domain)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), dt=0.05, min_bound=0.0, max_bound=32.0,
                        boundary="open", sort_frequency=4, force_impl="fused",
                        tile_order="morton")
    rng = np.random.default_rng(21)
    pos = rng.uniform(1.0, 31.0, (300, 3))
    blobs = [rng.uniform([15.0, 1.0, 4.0], [17.0, 31.0, 12.0], (40, 3)),
             rng.uniform([1.0, 15.0, 4.0], [31.0, 17.0, 12.0], (40, 3)),
             rng.uniform([15.2, 15.2, 4.0], [16.8, 16.8, 12.0], (20, 3))]
    pos = np.concatenate([pos] + blobs).astype(np.float32)
    mesh = make_mesh((2, 2), ("data", "model"), devices=CPU)
    return mesh, dcfg, ecfg, dist.init_dist_state(dcfg, capacity=256, positions=pos,
                                                  diameter=1.6)


def test_overlapped_schedule_keys_each_pass():
    """The overlapped schedule runs two force passes a rank, over different
    indexes: each keys and checks its own predicates (the interior pass's
    Morton window and ids, the shell pass's overflow), and the replayed run
    equals the eager one."""
    mesh, dcfg, ecfg, state = _overlap_setup()
    step = dist.make_distributed_step(mesh, dcfg, ecfg)
    eager = state
    for _ in range(6):
        eager = step(eager)
    runner = dist.jitted_distributed_runner(mesh, dcfg, ecfg)
    final, obs = runner(state, 6)
    J.assert_runs_bit_equal((eager, {}), (final, obs))
    assert runner.stats["replays"] >= 6 - runner.stats["eager_steps"]
    names = {name for key in runner._graphs for name, _ in key[1]}
    for r in range(4):
        assert {f"rank{r}/interior/window", f"rank{r}/interior/negative",
                f"rank{r}/interior/overflowed", f"rank{r}/shell/overflowed"} <= names
    assert not any(n.endswith("shell/window") for n in names)


def test_one_rank_flips_and_rolls_back():
    """One rank's ``overflowed`` predicate flips mid-run (12 agents of rank
    0's box stacked in one cell of 8 from step 4 on): the run rolls back, stays
    bit-identical to the eager run, and every other rank keeps its branch."""
    dsim = J.dist_crowd(CPU)
    (final, _), counts = _both(dsim, 10)
    assert counts["rollbacks"] >= 1
    keys = [dict(key[1]) for key in dsim._jitted._graphs]
    assert {key["rank0/overflowed"] for key in keys} == {False, True}
    for r in (1, 2, 3):
        assert {key[f"rank{r}/overflowed"] for key in keys} == {False}
    assert bool(final.health.cell_overflow_steps[0] > 0)
    assert not bool((final.health.cell_overflow_steps[1:] > 0).any())


class _Killed(Exception):
    pass


def test_resume_jit_from_an_eager_checkpoint(tmp_path):
    """A run killed after its first chunk, written eagerly, finished by
    ``resume(jit=True)``: the eager straight run's state and series; the
    later chunks replay the graphs the first resumed chunk captured."""
    straight = _resume_model().run(12)

    def kill(state):
        if int(state.step.reshape(-1)[0]) >= 3:
            raise _Killed

    with pytest.raises(_Killed):
        _resume_model().run(12, checkpoint_dir=str(tmp_path), checkpoint_every=3,
                            on_chunk=kill)
    dsim = _resume_model()
    resumed = dsim.resume(str(tmp_path), jit=True)
    J.assert_runs_bit_equal(straight, resumed)
    stats = dsim._jitted.stats
    assert stats["runs"] == 3 and stats["warm_starts"] == 2 and stats["replays"] > 0


def test_second_run_starts_warm_and_captures_nothing():
    """A second ``run_jit`` from the same start replays from its first step:
    no new graph, no eager step."""
    dsim = _resume_model()
    first = dsim.run_jit(6)
    graphs = dsim._jitted.stats["graphs"]
    again = dsim.run_jit(6)
    J.assert_runs_bit_equal(first, again)
    stats = dsim._jitted.stats
    assert stats["graphs"] == graphs and stats["warm_starts"] == 1
    assert stats["eager_steps"] == graphs      # the first run's warm-ups only


def test_a_mesh_over_two_devices_raises():
    """The compiled run needs every rank on one device; a mesh whose ranks
    sit on two cards raises before anything runs (the check reads only the
    mesh's device list)."""
    dsim = _resume_model()
    two = Mesh(axis_names=dsim.mesh.axis_names, axis_sizes=dsim.mesh.axis_sizes,
               devices=tuple(torch.device("cuda", r % 2) for r in range(4)))
    with pytest.raises(ValueError, match="one device"):
        dataclasses.replace(dsim, mesh=two).run_jit(2)
    with pytest.raises(ValueError, match="item 17"):
        dist.jitted_distributed_runner(two, dsim.dcfg, dsim.config)


def test_a_leaf_changed_on_one_rank_is_committed():
    """A field that diffuses every other step, and an op that adds to rank
    0's field alone (its Python sees the ranks in order): on the steps
    without diffusion only rank 0's rows of the leaf change, and the commit
    writes them, as the eager run does."""
    calls = []

    def feed_rank0(ctx, state):
        calls.append(None)
        if len(calls) % 4 != 1:
            return state
        g = state.grids["s"]
        return dataclasses.replace(state, grids={"s": dataclasses.replace(
            g, concentration=g.concentration + 1.0)})

    domain, space, pos, kinds = R.resume_setup()
    sim = (Simulation(space=(0.0, space), cell_size=2.0, boundary="open", dt=0.05,
                      max_per_cell=32, seed=3, sort_frequency=4, capacity=256,
                      diffusion_frequency=2, device="cpu")
           .add_agents(position=pos, diameter=1.6, kind=kinds)
           .add_substance("s", diffusion=1.0, resolution=8)
           .op(feed_rank0, name="feed_rank0", phase="post"))
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"], devices=CPU)
    dsim = sim.distribute(mesh, dist.DomainConfig(**domain))
    (final, _), _ = _both(dsim, 5)
    conc = final.grids["s"].concentration
    assert float(conc[0].sum()) > float(conc[1].sum())
