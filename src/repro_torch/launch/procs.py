"""Start a run of one process a rank on this host.

    from repro_torch.launch import procs

    results = procs.spawn(worker, 4, args=(...,), backend="gloo")

starts four processes (the ``spawn`` start method), each with the
environment ``torchrun`` gives its workers (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
an initialised default process group over ``tcp://localhost:<port>``, calls
``worker(*args)`` (a module-level function) in each, and returns their
return values in rank order.  The parent holds the group's store on a free
port, so no two runs race for one.  ``init_process_group`` gets a timeout of
:data:`INIT_TIMEOUT_S` seconds.  The first child that fails stops the run:
the others are terminated and ``spawn`` raises, naming the rank; a run
past ``timeout_s`` is stopped the same way.  ``kernels`` names CUDA kernels
to build in the parent first, so that R processes do not each run nvcc.

Under ``torchrun --standalone --nproc-per-node R script.py`` (which comes
with torch and needs no network) the script calls
``dist.init_process_group(backend)`` itself; then, as under ``spawn``,
``launch.mesh.process_mesh`` gives each process its rank of the mesh.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Iterable, List, Sequence

import torch.distributed as dist

INIT_TIMEOUT_S = 60.0


def _child(rank: int, world: int, port: int, backend: str, fn: Callable, args: Sequence,
           out_dir: str) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    try:
        store = dist.TCPStore("localhost", port, world, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
        result = fn(*args)
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(out_dir, f"rank{rank}.tmp"),
                   os.path.join(out_dir, f"rank{rank}.pkl"))
    except BaseException:
        trace = traceback.format_exc()
        sys.stderr.write(f"[rank {rank}] " + trace)
        sys.stderr.flush()
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{trace}")
        os._exit(1)


def _first_failure(out_dir: str, exits) -> str:
    """The rank that failed first (by the time its error was written; a rank
    that died without writing one, by its exit code) and its error."""
    failures = []
    for name in os.listdir(out_dir):
        if name.endswith(".err"):
            with open(os.path.join(out_dir, name)) as f:
                when, _, trace = f.read().partition("\n")
            last = trace.strip().splitlines()[-1] if trace.strip() else "no traceback"
            failures.append((float(when), int(name[4:-4]), last))
    if failures:
        _, rank, last = min(failures)
        return f"rank {rank} failed first: {last}"
    rank, code = exits[0]
    return f"rank {rank} exited with code {code}"


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *, backend: str = "gloo",
          timeout_s: float = 600.0, kernels: Iterable[str] = ()) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` processes of one process group;
    returns each rank's return value (pickled through a temporary
    directory), in rank order.  Raises ``RuntimeError`` when a child fails
    and ``TimeoutError`` past ``timeout_s``; no child outlives the call."""
    kernels = list(kernels)
    if kernels:
        from ..kernels import _build

        _build.build(kernels)
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    with tempfile.TemporaryDirectory(prefix="repro_procs_") as out_dir:
        children = [ctx.Process(target=_child, daemon=True,
                                args=(r, nprocs, store.port, backend, fn, tuple(args), out_dir))
                    for r in range(nprocs)]
        for p in children:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            while True:
                failed = [(r, p.exitcode) for r, p in enumerate(children)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"procs: {_first_failure(out_dir, failed)} ({nprocs} "
                                       f"ranks; the others were stopped)")
                running = [p.sentinel for p in children if p.exitcode is None]
                if not running:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"procs: {len(running)} of {nprocs} ranks still "
                                       f"running after {timeout_s} s; stopped")
                multiprocessing.connection.wait(running, timeout=min(left, 1.0))
        finally:
            for p in children:
                if p.is_alive():
                    p.terminate()
            for p in children:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(nprocs):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
