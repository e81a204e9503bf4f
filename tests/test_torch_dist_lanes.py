"""The distributed step's lanes (``repro_torch.core.lanes``) on the CPU.

On the CPU a lane has no stream, but its bookkeeping runs as on the card:
each lane's record of the collective shifts it waited on, the joins of the
exchange lane's products at their first read, the events and waits a step
makes.  So ``distributed.overlap_report``, the port's counterpart of the
reference's ``hlo_overlap_report``, is held here to the reference's rule
and to its zero / non-zero pattern on the same models (the reference
compiled in one subprocess with four forced host devices,
``tests/torch_overlap_reference.py``, beside the port's tests).  The layout
is tests/dist_scenarios.py's overlap-parity one (a 2×2 mesh, blobs on the
rank faces and corner); the divergence case crowds two ranks' boxes at
once, so that both ranks' slots of the compiled run's flag are set in one
chunk.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_jit_cases as J
import torch_overlap_reference as O
from torch_parity import CPU

from repro_torch.core import EngineConfig, ForceParams, Simulation
from repro_torch.core import distributed as dist
from repro_torch.core import lanes
from repro_torch.core.runner import Runner
from repro_torch.core.slots import tree_map
from repro_torch.launch.mesh import make_mesh

_HERE = os.path.dirname(os.path.abspath(__file__))
REF_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def ref_launch(tmp_path_factory):
    """The reference's compile, started with the module (it runs beside the
    port's tests)."""
    out = str(tmp_path_factory.mktemp("overlap_ref") / "ref.json")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(_HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, os.path.join(_HERE, "torch_overlap_reference.py"),
                             out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                            text=True)
    yield proc, time.monotonic(), out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _model(overlap, behaviour=False, **engine):
    domain, numbers, pos = O.overlap_setup()
    dcfg = dist.DomainConfig(**domain, overlap_halo=overlap)
    behaviours = (lambda c, p: O.shrink_crowded(c, p, torch.where),) if behaviour else ()
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), force_impl="reference",
                        behaviors=behaviours, **dict(numbers, **engine))
    mesh = make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=CPU)
    state = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6)
    return mesh, dcfg, ecfg, state


def _bytes(state):
    out = []
    tree_map(lambda x: out.append(x.numpy().tobytes()), state)
    return out


def _pattern(report, passes="passes"):
    """The zero / non-zero pattern of a report (the reference's counts its
    passes as ``conditionals``)."""
    out = {"halo_collectives": report["halo_collectives"] > 0}
    for name in dist.FORCE_OPS:
        r = report[name]
        out[name] = (r[passes] > 0, r["collective_ancestors"] > 0,
                     r["halo_collective_ancestors"] > 0)
    return out


@pytest.mark.parametrize("schedule", ["serial", "overlap"])
def test_overlap_report_follows_the_rule(schedule):
    """The reference's rule: overlapped, the interior pass has no halo
    ancestor and at least one migrate ancestor, the shell pass a halo
    ancestor; serial, the one force pass has a halo ancestor."""
    mesh, dcfg, ecfg, state = _model(schedule == "overlap")
    report = dist.overlap_report(mesh, dcfg, ecfg, state)
    assert report["halo_collectives"] == 2 * dcfg.n_decomposed
    if schedule == "serial":
        assert report["forces"]["passes"] == 1
        assert report["forces"]["halo_collective_ancestors"] >= 1
        assert report["interior_forces"]["passes"] == report["shell_forces"]["passes"] == 0
    else:
        interior, shell = report["interior_forces"], report["shell_forces"]
        assert report["forces"]["passes"] == 0
        assert interior["passes"] == shell["passes"] == 1
        assert interior["halo_collective_ancestors"] == 0
        assert interior["collective_ancestors"] >= 1
        assert shell["halo_collective_ancestors"] >= 1
        assert shell["collective_ancestors"] > interior["collective_ancestors"]
    # Every rank's lanes saw the same.
    with lanes.observe() as seen:
        dist.make_distributed_step(mesh, dcfg, ecfg)(state)
    by_rank = {}
    for r, op, rec in seen.passes:
        by_rank.setdefault(r, []).append((op, len(rec)))
    assert sorted(by_rank) == [0, 1, 2, 3]
    assert all(v == by_rank[0] for v in by_rank.values())


def test_a_neighbour_reading_behaviour_joins_the_exchange():
    """A behaviour that reads the ghost-extended candidates makes the
    compute lane wait on the exchange before the interior pass, as the
    reference's dataflow makes the pass depend on the halo; the two
    schedules stay bit-identical."""
    mesh, dcfg, ecfg, state = _model(True, behaviour=True)
    report = dist.overlap_report(mesh, dcfg, ecfg, state)
    assert report["interior_forces"]["halo_collective_ancestors"] >= 1
    serial = dist.make_distributed_step(mesh, dataclasses.replace(dcfg, overlap_halo=False),
                                        ecfg)
    overlap = dist.make_distributed_step(mesh, dcfg, ecfg)
    a = b = state
    for _ in range(6):
        a, b = serial(a), overlap(b)
    assert _bytes(a) == _bytes(b)
    assert bool((a.pool.diameter[a.pool.alive] < 1.6).any())


def test_the_exchange_products_join_at_their_first_read():
    """In the overlapped step the exchange's products reach the compute
    lane only where they are read: the behaviours and the interior pass
    of a model without neighbour reads see no halo shift, the shell pass
    does; every pass is issued from its rank's compute lane."""
    mesh, dcfg, ecfg, state = _model(True)
    seen_lanes = []
    real = lanes.force_pass_issued

    def spy():
        lane = lanes.current()
        seen_lanes.append((lane.rank, lane.role))
        real()

    step = dist.make_distributed_step(mesh, dcfg, ecfg)
    try:
        lanes.force_pass_issued = spy
        step(state)
    finally:
        lanes.force_pass_issued = real
    assert sorted(set(seen_lanes)) == [(r, "compute") for r in range(4)]
    sets = lanes.lanes_for(step.mesh)
    for r in range(4):
        assert sets.compute[r].stream is None and sets.exchange[r].stream is None
        halo = {t for t in sets.exchange[r].record if t[0] == "halo_exchange"}
        assert len(halo) == 2 * dcfg.n_decomposed
        # The step's end: every lane's record holds every shift it saw.
        assert halo <= sets.compute[r].record


def test_pending_forwards_to_its_value_and_joins_once():
    producer = lanes.Lane(0, "exchange", CPU, None)
    reader = lanes.Lane(0, "compute", CPU, None)
    producer.record = frozenset({("halo_exchange", 0)})
    with producer.entered():
        t = lanes.product(torch.arange(4, dtype=torch.int32))
    assert isinstance(t, lanes.Pending)
    assert lanes.product("plain") == "plain"       # outside every lane
    before = lanes.counts.waits
    with producer.entered():
        assert int((t + 1).sum()) == 10            # the producer reads without a join
    assert reader.record == frozenset() and lanes.counts.waits == before
    with reader.entered():
        assert torch.equal(torch.where(t > 1, t, 0), torch.tensor([0, 0, 2, 3],
                                                                   dtype=torch.int32))
        assert t.to(torch.int64).dtype == torch.int64
        assert len(t) == 4 and list(t) == [0, 1, 2, 3] and 2 - t[1] == 1
    assert reader.record == producer.record
    assert lanes.counts.waits == before + 1       # one join, at the first read


def test_events_and_waits_of_a_step():
    """Events and waits are made once an op and rank, never a kernel: the
    overlapped step of four ranks makes the same few dozen each time."""
    mesh, dcfg, ecfg, state = _model(True)
    step = dist.make_distributed_step(mesh, dcfg, ecfg)
    made = []
    for _ in range(2):
        lanes.counts.reset()
        state = step(state)
        made.append((lanes.counts.events, lanes.counts.waits))
    assert made[0] == made[1]
    events, waits = made[0]
    assert 0 < events <= 16 * 4 and 0 < waits <= 16 * 4


def test_run_jit_with_a_neighbour_behaviour_equals_run():
    """The overlapped model with the neighbour-reading behaviour through
    the compiled run: bit for bit the eager run."""
    mesh, dcfg, ecfg, state = _model(True, behaviour=True)
    runner = dist.jitted_distributed_runner(mesh, dcfg, ecfg)
    obs = (("pop", lambda s: s.pool.alive.sum(dtype=torch.int32), 1),)
    eager_state, rows = state, []
    step = dist.make_distributed_step(mesh, dcfg, ecfg)
    for _ in range(5):
        eager_state = step(eager_state)
        rows.append(obs[0][1](eager_state))
    final, got = runner(state, 5, observables=obs)
    assert _bytes(final) == _bytes(eager_state)
    assert torch.equal(got["pop"], torch.stack(rows))
    assert runner.stats["replays"] >= 3


def _two_rank_crowd():
    """J.dist_crowd with its crowd split over two ranks' boxes: 12 agents
    in rank 0's box and 12 in rank 3's, stacked at each box's centre from
    step 4 on, so that both ranks' ``overflowed`` predicates flip in the
    same replayed step."""
    import torch_dist_reference as R

    k = 12
    domain, space, pos, kinds = R.resume_setup()
    rng = np.random.default_rng(2)
    heads = [rng.uniform([4.0, 4.0, 8.0], [12.0, 12.0, 24.0], (k, 3)),
             rng.uniform([20.0, 20.0, 8.0], [28.0, 28.0, 24.0], (k, 3))]
    pos = np.concatenate(heads + [pos[2 * k:]]).astype(np.float32)
    sim = (Simulation(space=(0.0, space), cell_size=2.0, boundary="open", dt=0.05,
                      max_per_cell=8, seed=3, sort_frequency=4, capacity=256,
                      rank_impl="cuda", device=CPU)
           .add_agents(position=pos, diameter=1.6, kind=kinds,
                       gid=np.arange(pos.shape[0], dtype=np.int32))
           .mechanics(ForceParams(), impl="fused")
           .op(J.crowd_gid_op(2 * k, 4, 8.0), name="crowd", phase="agent")
           .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32)))
    mesh = make_mesh(domain["axis_sizes"], domain["mesh_axes"], devices=CPU)
    return sim.distribute(mesh, dist.DomainConfig(**domain))


def test_two_ranks_diverging_in_one_chunk_both_set_their_slots(monkeypatch):
    """Each rank sets its own slot of the divergence flag: two ranks
    diverging in the same replayed step are both seen in the chunk's one
    read, and the rollback gives the eager run bit for bit."""
    dsim = _two_rank_crowd()
    reads = []
    real = Runner._diverged

    def spy(self, lay):
        reads.append(lay.diverged.tolist())
        return real(self, lay)

    monkeypatch.setattr(Runner, "_diverged", spy)
    eager_final, eager_obs = dsim.run(10)
    final, obs = dsim.run_jit(10)
    assert _bytes(final) == _bytes(eager_final)
    assert torch.equal(obs["pop"], eager_obs["pop"])
    runner = dsim._jitted
    assert runner.stats["rollbacks"] >= 1
    assert [True, False, False, True] in reads
    keys = [dict(key[1]) for key in runner._graphs]
    for r, flips in ((0, {False, True}), (1, {False}), (2, {False}), (3, {True, False})):
        assert {key[f"rank{r}/overflowed"] for key in keys} == flips
    assert bool((final.health.cell_overflow_steps[[0, 3]] > 0).all())


def test_overlap_report_pattern_equals_the_reference(ref_launch):
    """The zero / non-zero pattern of the port's report equals the
    reference's ``hlo_overlap_report`` of the compiled step, for both
    models under both schedules."""
    proc, start, out = ref_launch
    try:
        log, _ = proc.communicate(timeout=max(1.0, REF_TIMEOUT_S - (time.monotonic() - start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the reference's compile took over {REF_TIMEOUT_S} s")
    assert proc.returncode == 0, log[-8000:]
    with open(out) as f:
        ref = json.load(f)
    for model in O.MODELS:
        for schedule in O.SCHEDULES:
            mesh, dcfg, ecfg, state = _model(schedule == "overlap",
                                             behaviour=model == "neighbour_behaviour")
            port = dist.overlap_report(mesh, dcfg, ecfg, state)
            want = ref[f"{model}/{schedule}"]
            assert _pattern(port) == _pattern(want, "conditionals"), (model, schedule, port,
                                                                      want)
