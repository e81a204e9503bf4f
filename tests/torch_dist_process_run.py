"""The port's distributed engine with one process a rank, on the CPU, over gloo.

    PYTHONPATH=src python tests/torch_dist_process_run.py engine OUT.npz CKPT_IN CKPT_OUT
    PYTHONPATH=src python tests/torch_dist_process_run.py shifts OUT.npz

``engine`` starts eight processes (``repro_torch.launch.procs.spawn``), one
a rank of the reference's 4×2 force relaxation (tests/
torch_dist_reference.py), and runs on them every case of
tests/test_torch_distributed.py that this mode covers: the relaxation at
both codecs after 1 and 5 steps on all eight, then on the first four (a
subgroup) the 2×2 soma model through ``Simulation.distribute``, the resume
model straight and killed after step ``RESUME_KILL`` with its checkpoints
in CKPT_OUT, the resume model finishing CKPT_IN (an in-process killed
run), and ``distributed.overlap_report`` of tests/
torch_overlap_reference.py's force model under both schedules (each
process's report, as JSON, beside its digests).  ``shifts`` starts four processes: ``Mesh.shift`` on (2, 2) and
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

    torch.set_num_threads(1)
    out, digests = {}, {}

    def put(key, state):
        out.update(R.flatten(dist_state_to_numpy(state), key + "/"))
        digests[key] = digest(state)

    # 1. The 4×2 force relaxation on all eight processes.
    for codec in R.FORCE_CODECS:
        domain, dcfg, ecfg, pos = force_engine(codec)
        mesh = process_mesh(domain["axis_sizes"], domain["mesh_axes"], devices="cpu")
        step = dist.make_distributed_step(mesh, dcfg, ecfg)
        state = dist.init_dist_state(dcfg, capacity=192, positions=pos, diameter=1.6)
        for i in range(1, max(R.FORCE_STEPS) + 1):
            state = step(state)
            if i in R.FORCE_STEPS:
                put(f"force/{codec}/{i}", state)

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
