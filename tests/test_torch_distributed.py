"""The port's distributed engine against the reference, from the same inputs.

The reference needs several devices: it runs once for the module, in one
subprocess with eight forced host devices (``tests/torch_dist_reference.py``),
and writes its results into an ``.npz``.  The port runs here on the CPU on
an in-process mesh, from the reference's initial state carried across by
``convert.dist_state_from_numpy`` or from its own ``Simulation.distribute``
of the same description.  Beside the reference's subprocess, one more runs
the port with one process a rank over gloo (``tests/
torch_dist_process_run.py engine``, eight processes, every case in one
launch, eager and through the compiled run); its results must equal the
in-process port's exactly, and so the reference's at the same tolerances.

Tolerances: integer and bool leaves (pool order, alive, kind, counters,
wire bytes, codec ids, the ghost frame's alive and kind) are exact.  Float
leaves are within 1e-5 after one step and within one int16 quantum,
``(extent + 2·halo) / 32767``, after five or more: the reference's XLA
contracts the codec's ``ref + q·s`` into an FMA for some columns, the port
rounds the product first, so a ghost coordinate may differ by one ulp and
the force chain carries it on (on the 4×2 case the two agree bit for bit
after one step and to one ulp after five).
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_dist_process_run as P
import torch_dist_reference as R
import torch_jit_cases as J
from torch_parity import CPU

from repro_torch.convert import dist_state_from_numpy, dist_state_to_numpy
from repro_torch.core import EngineConfig, ForceParams, Simulation
from repro_torch.core import distributed as dist
from repro_torch.launch.mesh import make_mesh

_HERE = os.path.dirname(__file__)


def _mesh(domain):
    return make_mesh(domain["axis_sizes"], domain["mesh_axes"], devices="cpu")


def _resume_model():
    domain = R.resume_setup()[0]
    return P.resume_sim().distribute(_mesh(domain), dist.DomainConfig(**domain))


def _killed_run(checkpoint_dir):
    """The resume model's checkpointed run, stopped after ``RESUME_KILL``."""
    with pytest.raises(P.Killed):
        _resume_model().run(R.RESUME_STEPS, checkpoint_dir=checkpoint_dir,
                            checkpoint_every=R.RESUME_EVERY, on_chunk=P.killer)


def _env(**extra):
    return dict(os.environ, **extra,
                PYTHONPATH=os.pathsep.join([os.path.join(_HERE, "..", "src"),
                                            os.environ.get("PYTHONPATH", "")]))


PROCS_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def procs_launch(tmp_path_factory):
    """Starts the one-process-a-rank run (it goes on beside the reference's
    subprocess); first the in-process killed run it resumes."""
    tmp = tmp_path_factory.mktemp("dist_procs")
    in_process_ckpt = str(tmp / "in_process_ckpt")
    _killed_run(in_process_ckpt)
    out, ckpt, log = str(tmp / "procs.npz"), str(tmp / "procs_ckpt"), tmp / "procs.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "torch_dist_process_run.py"), "engine", out,
             in_process_ckpt, ckpt], stdout=f, stderr=subprocess.STDOUT, env=_env())
    yield proc, time.monotonic(), out, ckpt, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def procs(procs_launch):
    """The one-process-a-rank run's results (and ``_ckpt``: its killed
    run's checkpoints), within ``PROCS_TIMEOUT_S`` of its start."""
    proc, start, out, ckpt, log = procs_launch
    try:
        proc.wait(timeout=max(1.0, PROCS_TIMEOUT_S - (time.monotonic() - start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        pytest.fail(f"the process run took over {PROCS_TIMEOUT_S} s:\n{log.read_text()[-4000:]}")
    assert proc.returncode == 0, log.read_text()[-8000:]
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["_ckpt"] = ckpt
    return arrays


@pytest.fixture(scope="module")
def ref(tmp_path_factory, procs_launch):
    """The reference's results; first the port's killed run it resumes."""
    tmp = tmp_path_factory.mktemp("dist_ref")
    port_ckpt = str(tmp / "port_ckpt")
    _killed_run(port_ckpt)
    out = str(tmp / "ref.npz")
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(_HERE, "torch_dist_reference.py"),
                           out, port_ckpt], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["_dir"] = out
    return arrays


def _state(ref, key):
    return dist_state_from_numpy(R.unflatten(ref, key), CPU)


def _assert_matches(port_np, ref_np, tol, label):
    """Every leaf of two numpy-layout states: integers and bools exact,
    floats within ``tol``."""
    got, want = R.flatten(port_np), R.flatten(ref_np)
    assert sorted(got) == sorted(want), (label, sorted(set(got) ^ set(want)))
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, (label, key, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{label}: {key}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {key}")


def _float_tol(steps, domain):
    if steps <= 1:
        return 1e-5
    return (domain["extent"] + 2 * domain["halo_width"]) / 32767.0


# ------------------------------------------------------------------ cases


def test_init_dist_state_matches_reference(ref):
    """Binning, rebasing, codec scale, keys and buffers of the initial state."""
    domain, engine, pos = R.force_setup()
    for codec in R.FORCE_CODECS:
        dcfg = dist.DomainConfig(**domain, halo_codec=codec)
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
        _assert_matches(dist_state_to_numpy(state), R.unflatten(ref, f"force/{codec}/0"),
                        0.0, f"init {codec}")


@pytest.mark.parametrize("codec", R.FORCE_CODECS)
def test_force_relaxation_matches_reference(ref, codec):
    """tests/dist_scenarios.py's 4×2 relaxation after 1 and 5 steps: the
    whole stacked state, codec state, ghost frame and counters included."""
    domain, engine, _ = R.force_setup()
    dcfg = dist.DomainConfig(**domain, halo_codec=codec)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), **engine)
    step = dist.make_distributed_step(_mesh(domain), dcfg, ecfg)
    state = _state(ref, f"force/{codec}/0")
    for i in range(1, max(R.FORCE_STEPS) + 1):
        state = step(state)
        if i in R.FORCE_STEPS:
            _assert_matches(dist_state_to_numpy(state), R.unflatten(ref, f"force/{codec}/{i}"),
                            _float_tol(i, domain), f"{codec} step {i}")
    assert int(state.halo_payload_bytes[0]) > 0


@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
def test_distributed_diffuse_uneven_split_matches_reference(ref, boundary):
    """The facade's ghost-voxel split (n_valid, frame_shift, blocks) and
    three distributed_diffuse steps on it."""
    domain, space, res, field, pos = R.diffuse_setup()
    dcfg = dist.DomainConfig(**domain)
    sim = (Simulation(space=(0.0, space), cell_size=2.0, boundary="closed", dt=0.05,
                      max_per_cell=32, capacity=16, device="cpu")
           .add_agents(position=pos, diameter=1.6)
           .add_substance("s", diffusion=1.0, resolution=res, concentration=field))
    stacked = sim._split_grids(dcfg, CPU)["s"]
    np.testing.assert_array_equal(stacked.n_valid.numpy(), ref["diffuse/n_valid"])
    np.testing.assert_array_equal(stacked.frame_shift.numpy(), ref["diffuse/frame_shift"])
    np.testing.assert_array_equal(stacked.concentration.numpy(), ref["diffuse/0"])
    mesh = _mesh(domain)
    grids = [dataclasses.replace(stacked, concentration=stacked.concentration[r],
                                 n_valid=stacked.n_valid[r],
                                 frame_shift=stacked.frame_shift[r]) for r in range(4)]
    for _ in range(R.DIFFUSE_STEPS):
        grids = dist.distributed_diffuse(dcfg, mesh, grids, 0.05, boundary)
    got = np.stack([g.concentration.numpy() for g in grids])
    np.testing.assert_allclose(got, ref[f"diffuse/{boundary}"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("codec", R.FORCE_CODECS)
def test_force_relaxation_run_jit_matches_reference(ref, codec):
    """The same relaxation through the compiled run
    (``jitted_distributed_runner``): 1 step, then 4 more from it, each held
    to the reference's state at that step."""
    domain, engine, _ = R.force_setup()
    dcfg = dist.DomainConfig(**domain, halo_codec=codec)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), **engine)
    runner = dist.jitted_distributed_runner(_mesh(domain), dcfg, ecfg)
    state, done = _state(ref, f"force/{codec}/0"), 0
    for i in R.FORCE_STEPS:
        state, _ = runner(state, i - done)
        done = i
        _assert_matches(dist_state_to_numpy(state), R.unflatten(ref, f"force/{codec}/{i}"),
                        _float_tol(i, domain), f"{codec} run_jit step {i}")
    assert runner.stats["replays"] > 0


def _soma_model():
    domain = R.soma_setup()[0]
    return domain, P.soma_sim().distribute(_mesh(domain), dist.DomainConfig(**domain),
                                           capacity=128)


def test_facade_soma_model_matches_reference(ref):
    """Simulation.distribute of a soma model on a 2×2 mesh: the initial
    state exactly, then 4 steps (series exact)."""
    domain, dsim = _soma_model()
    assert dsim.config.spec.rank_impl == "tiled"
    _assert_matches(dist_state_to_numpy(dsim.state), R.unflatten(ref, "soma/0"), 0.0, "init")
    final, obs = dsim.run(R.SOMA_STEPS)
    np.testing.assert_array_equal(obs["kinds"].numpy(), ref["soma/obs/kinds"])
    _assert_matches(dist_state_to_numpy(final), R.unflatten(ref, "soma/final"),
                    _float_tol(R.SOMA_STEPS, domain), "soma")


def test_facade_soma_model_run_jit_matches_reference(ref):
    """The same soma model through ``DistributedSimulation.run_jit``: the
    reference's series exactly and its final state at the same tolerances."""
    domain, dsim = _soma_model()
    final, obs = dsim.run_jit(R.SOMA_STEPS)
    assert dsim._jitted.stats["replays"] > 0
    np.testing.assert_array_equal(obs["kinds"].numpy(), ref["soma/obs/kinds"])
    _assert_matches(dist_state_to_numpy(final), R.unflatten(ref, "soma/final"),
                    _float_tol(R.SOMA_STEPS, domain), "soma run_jit")


def test_port_resumes_a_reference_checkpoint(ref):
    """The reference's killed run, finished by the port's resume: the
    reference's straight run's state and series."""
    domain = R.resume_setup()[0]
    final, obs = _resume_model().resume(ref["_dir"] + ".ckpt")
    np.testing.assert_array_equal(obs["counts"].numpy(), ref["resume/straight_obs/counts"])
    _assert_matches(dist_state_to_numpy(final), R.unflatten(ref, "resume/straight"),
                    _float_tol(R.RESUME_STEPS, domain), "port resume")


def test_reference_resumes_a_port_checkpoint(ref):
    """The port's killed run (the fixture's), finished by the reference:
    the port's straight run's state and series."""
    domain = R.resume_setup()[0]
    straight, obs = _resume_model().run(R.RESUME_STEPS)
    np.testing.assert_array_equal(obs["counts"].numpy(), ref["resume/of_port_obs/counts"])
    _assert_matches(dist_state_to_numpy(straight), R.unflatten(ref, "resume/of_port"),
                    _float_tol(R.RESUME_STEPS, domain), "reference resume")


def test_run_elastic_distributed_matches_reference(ref, tmp_path):
    """Regrows, the population series and every integer leaf exact."""
    _check_elastic(ref, tmp_path, jit=False)


def test_run_elastic_distributed_jit_matches_reference(ref, tmp_path):
    """The same with each chunk through ``run_jit``."""
    _check_elastic(ref, tmp_path, jit=True)


def _check_elastic(ref, tmp_path, jit):
    domain = R.elastic_setup()[0]
    final, obs, grows = P.run_elastic(_mesh(domain), str(tmp_path), jit)
    assert grows == int(ref["elastic/grows"]) >= 1
    np.testing.assert_array_equal(obs["pop"].numpy(), ref["elastic/obs/pop"])
    _assert_matches(dist_state_to_numpy(final), R.unflatten(ref, "elastic/final"),
                    _float_tol(R.ELASTIC_STEPS, domain), "elastic")


# ------------------------------------------------------- one process a rank


def _assert_same(port_state, procs, key, label):
    """A port state equal, leaf for leaf and bit for bit, to the process
    run's state under ``key``, which every process of that run held."""
    got = R.flatten(dist_state_to_numpy(port_state))
    want = R.flatten(R.unflatten(procs, key))
    assert sorted(got) == sorted(want), (label, sorted(set(got) ^ set(want)))
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k)
        assert a.tobytes() == b.tobytes(), f"{label}: {k} differs from the in-process run"
    digests = {str(procs[k]) for k in procs if k.rsplit("/", 1)[0] == f"digest/{key}"}
    assert len(digests) == 1, f"{label}: the processes hold different states"


@pytest.mark.parametrize("codec", R.FORCE_CODECS)
def test_process_mesh_force_relaxation_matches(ref, procs, codec):
    """The 4×2 relaxation with one process a rank (eight gloo processes):
    after 1 and 5 steps the in-process port's state exactly, and so the
    reference's within the file's tolerances."""
    domain, dcfg, ecfg, _ = P.force_engine(codec)
    step = dist.make_distributed_step(_mesh(domain), dcfg, ecfg)
    state = _state(ref, f"force/{codec}/0")
    for i in range(1, max(R.FORCE_STEPS) + 1):
        state = step(state)
        if i in R.FORCE_STEPS:
            key = f"force/{codec}/{i}"
            _assert_same(state, procs, key, f"processes {key}")
            _assert_matches(R.unflatten(procs, key), R.unflatten(ref, key),
                            _float_tol(i, domain), f"processes {key} vs reference")


def test_process_mesh_soma_model_matches(ref, procs):
    """Simulation.distribute of the soma model on a 2×2 mesh of four
    processes (a subgroup of the eight): the series and final state of the
    in-process run exactly, and the reference's at the file's tolerances."""
    domain, dsim = _soma_model()
    final, obs = dsim.run(R.SOMA_STEPS)
    np.testing.assert_array_equal(procs["soma/obs/kinds"], obs["kinds"].numpy())
    np.testing.assert_array_equal(procs["soma/obs/kinds"], ref["soma/obs/kinds"])
    _assert_same(final, procs, "soma/final", "processes soma")
    _assert_matches(R.unflatten(procs, "soma/final"), R.unflatten(ref, "soma/final"),
                    _float_tol(R.SOMA_STEPS, domain), "processes soma vs reference")


def test_process_mesh_checkpoint_resumes_in_process(ref, procs):
    """A run of four processes checkpointed every RESUME_EVERY steps and
    stopped after RESUME_KILL, finished by an in-process resume: the
    straight run's state and series (in-process and multi-process)."""
    domain = R.resume_setup()[0]
    straight, sobs = _resume_model().run(R.RESUME_STEPS)
    final, obs = _resume_model().resume(procs["_ckpt"])
    np.testing.assert_array_equal(obs["counts"].numpy(), sobs["counts"].numpy())
    np.testing.assert_array_equal(procs["resume/straight_obs/counts"], sobs["counts"].numpy())
    _assert_same(straight, procs, "resume/straight", "processes straight")
    _assert_same(final, procs, "resume/straight", "in-process resume of the processes' run")
    _assert_matches(R.unflatten(procs, "resume/straight"), R.unflatten(ref, "resume/straight"),
                    _float_tol(R.RESUME_STEPS, domain), "processes straight vs reference")


def test_process_mesh_resumes_an_in_process_checkpoint(procs):
    """The reverse: an in-process run stopped after RESUME_KILL, finished by
    four processes, equals the straight run."""
    straight, sobs = _resume_model().run(R.RESUME_STEPS)
    np.testing.assert_array_equal(procs["resume/of_in_process_obs/counts"],
                                  sobs["counts"].numpy())
    _assert_same(straight, procs, "resume/of_in_process", "processes' resume")


@pytest.mark.parametrize("schedule", ["serial", "overlap"])
def test_process_mesh_overlap_report_matches(procs, schedule):
    """Each of the four processes' ``overlap_report`` (its one rank's lanes,
    each receiving shift recorded by number) equals the in-process mesh's."""
    import json

    import torch_overlap_reference as O

    assert schedule in O.SCHEDULES
    want = dist.overlap_report(*P.overlap_model(schedule, "cpu"))
    for r in range(4):
        got = json.loads(str(procs[f"digest/overlap/{schedule}/{r}"]))
        assert got == want, (r, got, want)


# ------------------------------------ one process a rank, the compiled run


def _stats(procs, key, ranks):
    """Each process's ``Runner.stats`` of the compiled run under ``key``."""
    import json

    out = [json.loads(str(procs[f"digest/stats/{key}/{r}"])) for r in range(ranks)]
    for s in out:
        # The only eager steps: cold starts, missing graphs, rolled-back chunks.
        assert s["eager_steps"] == (s["runs"] - s["warm_starts"] + s["missing_steps"]
                                    + s["peer_steps"] + s["rolled_back_steps"]), s
        assert s["replays"] > 0 and s["exchanges"] > 0, s
    return out


@pytest.mark.parametrize("codec", R.FORCE_CODECS)
def test_process_mesh_force_relaxation_run_jit_matches(ref, procs, codec):
    """The 4×2 relaxation through ``jitted_distributed_runner`` on eight
    processes (1 step, then 4 more from it): the in-process compiled run's
    state exactly, and so the reference's within the file's tolerances;
    every process replays and exchanges alike."""
    domain, dcfg, ecfg, _ = P.force_engine(codec)
    runner = dist.jitted_distributed_runner(_mesh(domain), dcfg, ecfg)
    state, done = _state(ref, f"force/{codec}/0"), 0
    for i in R.FORCE_STEPS:
        state, _ = runner(state, i - done)
        done = i
        key = f"force_jit/{codec}/{i}"
        _assert_same(state, procs, key, f"processes {key}")
        _assert_matches(R.unflatten(procs, key), R.unflatten(ref, f"force/{codec}/{i}"),
                        _float_tol(i, domain), f"processes {key} vs reference")
    stats = _stats(procs, f"force_jit/{codec}", 8)
    assert len({(s["replays"], s["exchanges"], s["eager_steps"]) for s in stats}) == 1


def test_process_mesh_soma_model_run_jit_matches(ref, procs):
    """``DistributedSimulation.run_jit`` of the soma model on four processes:
    the in-process ``run_jit``'s series and final state exactly, and the
    reference's series."""
    _, dsim = _soma_model()
    final, obs = dsim.run_jit(R.SOMA_STEPS)
    np.testing.assert_array_equal(procs["soma_jit/obs/kinds"], obs["kinds"].numpy())
    np.testing.assert_array_equal(procs["soma_jit/obs/kinds"], ref["soma/obs/kinds"])
    _assert_same(final, procs, "soma_jit/final", "processes soma run_jit")
    _stats(procs, "soma_jit", 4)


def test_process_mesh_resume_jit_matches(procs):
    """A checkpointed ``run_jit`` of four processes, killed after
    RESUME_KILL and finished by a new deployment's ``resume(jit=True)``:
    the straight run's state and series; its later chunk starts warm."""
    straight, sobs = _resume_model().run(R.RESUME_STEPS)
    np.testing.assert_array_equal(procs["resume_jit/obs/counts"], sobs["counts"].numpy())
    _assert_same(straight, procs, "resume_jit/final", "processes' resume(jit=True)")
    for s in _stats(procs, "resume_jit", 4):
        assert s["runs"] == 2 and s["warm_starts"] == 1, s


def test_process_mesh_crowd_rolls_back_together(procs):
    """tests/torch_jit_cases.py's one-rank flip on four processes: rank 0's
    ``overflowed`` predicate flips, every process rolls the same chunk back,
    and the result is the in-process compiled run's, bit for bit."""
    final, obs = J.dist_crowd(CPU).run_jit(10)
    np.testing.assert_array_equal(procs["crowd_jit/obs/pop"], obs["pop"].numpy())
    _assert_same(final, procs, "crowd_jit/final", "processes crowd run_jit")
    stats = _stats(procs, "crowd_jit", 4)
    assert len({(s["rollbacks"], s["rolled_back_steps"], s["replays"]) for s in stats}) == 1
    assert stats[0]["rollbacks"] >= 1
    assert stats[0]["overflowed"] == {"0": [False, True]}
    for r in (1, 2, 3):
        assert stats[r]["overflowed"] == {str(r): [False]}


def test_process_mesh_peer_lacking_a_graph_steps_all_eagerly(procs):
    """Rank 0's predicate flips at the first run's last step; in the next
    run it lacks the graph of a pattern the others have, so every process
    ends the chunk there and steps eagerly (rank 0 a missing step, the
    others a peer step): the eager run's state, bit for bit."""
    dsim = J.dist_crowd(CPU, at_step=P.PEER_AT)
    first, _ = dsim.run(P.PEER_STEPS[0])
    final, _ = dsim.run(P.PEER_STEPS[1], state=first)
    _assert_same(final, procs, "crowd_peer/final", "processes crowd, two runs")
    stats = _stats(procs, "crowd_peer", 4)
    assert len({(s["eager_steps"], s["replays"], s["rollbacks"]) for s in stats}) == 1
    assert stats[0]["peer_steps"] == 0 and stats[0]["missing_steps"] > 0
    for s in stats[1:]:
        assert s["peer_steps"] >= 1 and s["missing_steps"] < stats[0]["missing_steps"], s


@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_process_mesh_elastic_matches(procs, tmp_path, mode):
    """``run_elastic_distributed`` on four processes, eager and
    ``jit=True``: the in-process run's regrows, series and final state,
    bit for bit (that run is held to the reference above)."""
    domain = R.elastic_setup()[0]
    final, obs, grows = P.run_elastic(_mesh(domain), str(tmp_path), mode == "jit")
    assert grows == int(procs[f"elastic_{mode}/grows"]) >= 1
    np.testing.assert_array_equal(procs[f"elastic_{mode}/obs/pop"], obs["pop"].numpy())
    _assert_same(final, procs, f"elastic_{mode}/final", f"processes elastic {mode}")
