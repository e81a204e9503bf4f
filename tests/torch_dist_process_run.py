"""The port's distributed engine with one process a rank, on the CPU, over gloo.

    PYTHONPATH=src python tests/torch_dist_process_run.py engine OUT.npz CKPT_IN CKPT_OUT
    PYTHONPATH=src python tests/torch_dist_process_run.py shifts OUT.npz

``engine`` starts eight processes (``repro_torch.launch.procs.spawn``), one
a rank of the reference's 4×2 force relaxation (tests/
torch_dist_reference.py), and runs on them every case of
tests/test_torch_distributed.py that this mode covers: the relaxation at
both codecs after 1 and 5 steps on all eight, eagerly and through the
compiled run (``jitted_distributed_runner``), then on the first four (a
subgroup) the 2×2 soma model through ``Simulation.distribute`` (``run`` and
``run_jit``), the resume model straight and killed after step
``RESUME_KILL`` with its checkpoints in CKPT_OUT, the resume model
finishing CKPT_IN (an in-process killed run), the resume model's
checkpointed ``run_jit`` killed after ``RESUME_KILL`` and finished by
``resume(jit=True)`` (its checkpoints in CKPT_OUT + ``_jit``), the one-rank
flip model of tests/torch_jit_cases.py (``dist_crowd``) through ``run_jit``
(and flipping late, so that a later run finds one process without a graph),
``run_elastic_distributed`` of the regrowth case, eager and ``jit=True``,
and ``distributed.overlap_report`` of tests/torch_overlap_reference.py's
force model under both schedules (each process's report, as JSON, beside
its digests; each compiled run's ``Runner.stats`` likewise, under
``stats/``).  ``shifts`` starts four processes: ``Mesh.shift`` on (2, 2) and
(4, 1) process meshes, and the bytes each rank sends through it in one
distributed step on each; then three processes of which one fails, which
must fail the launch at once.  Rank 0 writes what the mode's tests read into
OUT.npz (keys joined by ``/``, as torch_dist_reference.py's); every rank
reports a digest of each stacked state it holds, so the tests see that all
processes hold the same.

Each process runs one intra-op thread (the port's CPU tests all do: with
several, the first ``torch.sqrt`` of a process has been seen to differ in
the last bit).  The port-side model descriptions live here, so that
tests/test_torch_distributed.py builds the same ones in-process.
"""

import dataclasses
import hashlib
import json
import sys
import time

import numpy as np
import torch

import torch_dist_reference as R
import torch_overlap_reference as O

from repro_torch.convert import dist_state_to_numpy
from repro_torch.core import EngineConfig, ForceParams, Simulation
from repro_torch.core import distributed as dist


# The crowd of torch_jit_cases.dist_crowd from step PEER_AT, through two
# run_jit runs of these lengths (rank 0's overflowed flips at step 9 of 0-15).
PEER_AT, PEER_STEPS = 8, (10, 6)


class Killed(Exception):
    pass


def killer(state):
    """``on_chunk`` that stops a run once it passed ``RESUME_KILL``."""
    if int(state.step.reshape(-1)[0]) >= R.RESUME_KILL:
        raise Killed


def soma_sim():
    """The 2×2 soma model of torch_dist_reference.soma_setup, undeployed."""
    from repro_torch.core import chemotaxis, concentration_at, secretion

    _, space, res, pos, kind, fields = R.soma_setup()

    def exposure_op(ctx, state):
        pool = state.pool
        c0 = concentration_at(state.grids["substance_0"], pool.position)
        c1 = concentration_at(state.grids["substance_1"], pool.position)
        own = torch.where(pool.kind == 0, c0, c1)
        dose = torch.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    return (Simulation(space=(0.0, space), cell_size=4.0, boundary="closed", dt=1.0,
                       max_per_cell=32, seed=4, device="cpu")
            .add_agents(position=pos, diameter=3.0, kind=kind, exposure=0.0)
            .add_substance("substance_0", diffusion=0.4, decay=0.002, resolution=res,
                           concentration=fields[0])
            .add_substance("substance_1", diffusion=0.4, decay=0.002, resolution=res,
                           concentration=fields[1])
            .use(secretion("substance_0", 1.0, kind=0), secretion("substance_1", 1.0, kind=1),
                 chemotaxis("substance_0", 0.75, kind=0),
                 chemotaxis("substance_1", 0.75, kind=1))
            .mechanics(ForceParams())
            .op(exposure_op, name="exposure", phase="post")
            .observe_kinds("kinds", n_kinds=2))


def resume_sim():
    """torch_dist_reference.resume_setup's model, undeployed."""
    _, space, pos, kinds = R.resume_setup()
    return (Simulation(space=(0.0, space), cell_size=2.0, boundary="open", dt=0.05,
                       max_per_cell=32, seed=3, sort_frequency=4, capacity=256, device="cpu")
            .add_agents(position=pos, diameter=1.6, kind=kinds)
            .mechanics(ForceParams())
            .observe_kinds("counts", n_kinds=2))


def elastic_sim():
    """torch_dist_reference.elastic_setup's dividing agents, undeployed,
    with their population every step."""
    from repro_torch.core import cell_division

    _, space, pos = R.elastic_setup()
    return (Simulation(space=(0.0, space), cell_size=3.0, boundary="open", dt=1.0,
                       max_per_cell=32, seed=2, capacity=256, device="cpu")
            .add_agents(position=pos, diameter=2.0)
            .use(cell_division(0.5))
            .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32)))


def run_elastic(mesh, checkpoint_dir, jit):
    """``run_elastic_distributed`` of :func:`elastic_sim` on ``mesh``: pools
    of 32 a rank, regrown up to four times."""
    from repro_torch.launch import elastic

    domain = R.elastic_setup()[0]
    return elastic.run_elastic_distributed(
        elastic_sim(), mesh, dist.DomainConfig(**domain), R.ELASTIC_STEPS, checkpoint_dir,
        checkpoint_every=R.ELASTIC_EVERY, capacity=32, max_regrows=4, jit=jit)


def branch_values(runner, name):
    """``{rank: sorted values}`` of the branch ``name`` over the runner's
    graphs' keys, for every rank whose key names it."""
    out = {}
    for key in runner._graphs:
        for k, v in key[1]:
            rank, _, rest = k.partition("/")
            if rest == name:
                out.setdefault(int(rank[4:]), set()).add(v)
    return {r: sorted(v) for r, v in out.items()}


def force_engine(codec):
    domain, engine, pos = R.force_setup()
    dcfg = dist.DomainConfig(**domain, halo_codec=codec)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), **engine)
    return domain, dcfg, ecfg, pos


def overlap_model(schedule, devices, group=None):
    """torch_overlap_reference's force model on a 2×2 mesh (a process mesh
    over ``group``, or an in-process one when ``group`` is None)."""
    from repro_torch.launch.mesh import make_mesh, process_mesh

    domain, numbers, pos = O.overlap_setup()
    dcfg = dist.DomainConfig(**domain, overlap_halo=schedule == "overlap")
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), force_impl="reference", **numbers)
    if group is None:
        mesh = make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=devices)
    else:
        mesh = process_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=devices, group=group)
    state = dist.init_dist_state(dcfg, capacity=256, positions=pos, diameter=1.6)
    return mesh, dcfg, ecfg, state


def digest(state) -> str:
    """SHA-1 of every leaf of a stacked state, in the numpy layout."""
    h = hashlib.sha1()
    flat = R.flatten(dist_state_to_numpy(state))
    for key in sorted(flat):
        h.update(key.encode())
        h.update(np.ascontiguousarray(flat[key]).tobytes())
    return h.hexdigest()


def _engine_rank(ckpt_in, ckpt_out):
    import torch.distributed as tdist

    from repro_torch.launch.mesh import process_mesh

    import torch_jit_cases as J

    torch.set_num_threads(1)
    out, digests = {}, {}

    def put(key, state):
        out.update(R.flatten(dist_state_to_numpy(state), key + "/"))
        digests[key] = digest(state)

    def stats(key, runner, **more):
        digests[f"stats/{key}"] = json.dumps(dict(runner.stats, **more), sort_keys=True)

    # 1. The 4×2 force relaxation on all eight processes, eager and compiled.
    for codec in R.FORCE_CODECS:
        domain, dcfg, ecfg, pos = force_engine(codec)
        mesh = process_mesh(domain["axis_sizes"], domain["mesh_axes"], devices="cpu")
        step = dist.make_distributed_step(mesh, dcfg, ecfg)
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
        for i in range(1, max(R.FORCE_STEPS) + 1):
            state = step(state)
            if i in R.FORCE_STEPS:
                put(f"force/{codec}/{i}", state)
        runner = dist.jitted_distributed_runner(mesh, dcfg, ecfg)
        state, done = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6), 0
        for i in R.FORCE_STEPS:
            state, _ = runner(state, i - done)
            done = i
            put(f"force_jit/{codec}/{i}", state)
        stats(f"force_jit/{codec}", runner)

    # 2. The 2×2 cases on the first four processes.
    group = tdist.new_group([0, 1, 2, 3])
    if tdist.get_rank() < 4:
        domain = R.soma_setup()[0]
        mesh = process_mesh(domain["axis_sizes"], domain["mesh_axes"], devices="cpu",
                            group=group)
        dsim = soma_sim().distribute(mesh, dist.DomainConfig(**domain), capacity=128)
        final, obs = dsim.run(R.SOMA_STEPS)
        put("soma/final", final)
        out["soma/obs/kinds"] = obs["kinds"].numpy()
        final, obs = dsim.run_jit(R.SOMA_STEPS)
        put("soma_jit/final", final)
        out["soma_jit/obs/kinds"] = obs["kinds"].numpy()
        stats("soma_jit", dsim._jitted)

        domain = R.resume_setup()[0]
        dsim = resume_sim().distribute(mesh, dist.DomainConfig(**domain))
        straight, sobs = dsim.run(R.RESUME_STEPS)
        put("resume/straight", straight)
        out["resume/straight_obs/counts"] = sobs["counts"].numpy()
        try:
            dsim.run(R.RESUME_STEPS, checkpoint_dir=ckpt_out, checkpoint_every=R.RESUME_EVERY,
                     on_chunk=killer)
        except Killed:
            pass
        else:
            raise AssertionError("the checkpointed run was not stopped")
        final, robs = dsim.resume(ckpt_in)
        put("resume/of_in_process", final)
        out["resume/of_in_process_obs/counts"] = robs["counts"].numpy()

        # The compiled run, checkpointed, killed and resumed by a new deployment.
        try:
            dsim.run_jit(R.RESUME_STEPS, checkpoint_dir=ckpt_out + "_jit",
                         checkpoint_every=R.RESUME_EVERY, on_chunk=killer)
        except Killed:
            pass
        else:
            raise AssertionError("the checkpointed run_jit was not stopped")
        fresh = resume_sim().distribute(mesh, dist.DomainConfig(**domain))
        final, robs = fresh.resume(ckpt_out + "_jit", jit=True)
        put("resume_jit/final", final)
        out["resume_jit/obs/counts"] = robs["counts"].numpy()
        stats("resume_jit", fresh._jitted)

        # Rank 0's overflowed predicate flips: every process rolls back.
        dsim = J.dist_crowd("cpu", mesh=mesh)
        final, obs = dsim.run_jit(10)
        put("crowd_jit/final", final)
        out["crowd_jit/obs/pop"] = obs["pop"].numpy()
        stats("crowd_jit", dsim._jitted,
              overflowed=branch_values(dsim._jitted, "overflowed"))

        # Rank 0 flips at the first run's last step, so in the next run it
        # lacks its graph of a pattern the others have: all step eagerly there.
        dsim = J.dist_crowd("cpu", at_step=PEER_AT, mesh=mesh)
        final, _ = dsim.run_jit(PEER_STEPS[1], state=dsim.run_jit(PEER_STEPS[0])[0])
        put("crowd_peer/final", final)
        stats("crowd_peer", dsim._jitted)

        # The elastic run, eager and compiled, regrowing the pools.
        for mode in ("eager", "jit"):
            final, obs, grows = run_elastic(mesh, f"{ckpt_out}_elastic_{mode}", mode == "jit")
            put(f"elastic_{mode}/final", final)
            out[f"elastic_{mode}/obs/pop"] = obs["pop"].numpy()
            out[f"elastic_{mode}/grows"] = np.asarray(grows)

        # The overlap report of each schedule, from this process's lanes.
        for schedule in O.SCHEDULES:
            mesh, dcfg, ecfg, state = overlap_model(schedule, "cpu", group)
            digests[f"overlap/{schedule}"] = json.dumps(
                dist.overlap_report(mesh, dcfg, ecfg, state), sort_keys=True)
    tdist.barrier()
    return out, digests


def _shift_rank():
    from repro_torch.launch.mesh import count_shift_bytes, process_mesh

    torch.set_num_threads(1)
    out = {}
    for shape in ((2, 2), (4, 1)):
        tag = "x".join(map(str, shape))
        mesh = process_mesh(shape, ("a", "b"), devices="cpu")
        r = mesh.rank
        for axis in ("a", "b"):
            for direction in (1, -1):
                value = {"rank": torch.tensor([r, 100 + r], dtype=torch.int32),
                         "flag": torch.tensor([r % 2 == 0]),
                         "pos": torch.full((3, 3), float(r)),
                         "kind": torch.tensor(r).to(torch.int8)}
                got = mesh.shift([value], axis, direction)[0]
                key = f"{tag}/{axis}/{direction:+d}"
                for k, v in got.items():
                    out[f"{key}/{k}"] = v.numpy()
                out[f"{key}/same_object"] = np.asarray(got is value)
        dcfg, ecfg, pos = shift_engine(shape)
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
        step = dist.make_distributed_step(mesh, dcfg, ecfg)
        with count_shift_bytes() as sent:
            stepped = step(state)
        for axis, n in sent.on_axes(r).items():
            out[f"{tag}/bytes/{axis}"] = np.asarray(n)
        out[f"{tag}/senders"] = np.asarray(sorted(sent.ranks()))
        out[f"{tag}/step_digest"] = np.asarray(digest(stepped))
    return out


def fail_on(rank):
    """Raise on ``rank``; the other ranks wait in a barrier it never joins."""
    import torch.distributed as tdist

    if tdist.get_rank() == rank:
        raise RuntimeError("a planned failure")
    tdist.barrier()


def shift_engine(shape):
    """One relaxation step's engine on an (a, b) mesh of ``shape``: the
    force case's numbers, its agents inside the mesh's space."""
    domain, engine, pos = R.force_setup()
    dcfg = dist.DomainConfig(mesh_axes=("a", "b"), axis_sizes=shape, extent=16.0,
                             halo_width=2.0, halo_capacity=96, migrate_capacity=48, depth=16.0)
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32),
                        force_params=ForceParams(), **engine)
    hi = np.array([shape[0] * 16.0, shape[1] * 16.0, 16.0], np.float32)
    keep = (pos < hi - 0.5).all(axis=1)
    return dcfg, ecfg, pos[keep][:400]


def main(argv):
    from repro_torch.launch import procs

    mode, out_path = argv[0], argv[1]
    if mode == "engine":
        results = procs.spawn(_engine_rank, 8, args=(argv[2], argv[3]), timeout_s=110)
        arrays = dict(results[0][0])
        for r, (_, digests) in enumerate(results):
            for key, d in digests.items():
                arrays[f"digest/{key}/{r}"] = np.asarray(d)
    elif mode == "shifts":
        results = procs.spawn(_shift_rank, 4, timeout_s=80)
        arrays = {f"rank{r}/{k}": v for r, res in enumerate(results) for k, v in res.items()}
        start = time.monotonic()
        try:
            procs.spawn(fail_on, 3, args=(1,), timeout_s=30)
        except RuntimeError as err:
            arrays["failure/message"] = np.asarray(str(err))
        arrays["failure/seconds"] = np.asarray(time.monotonic() - start)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    np.savez(out_path, **arrays)


if __name__ == "__main__":
    main(sys.argv[1:])
