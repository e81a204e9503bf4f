"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Every kernel lives in a ``kernels/<module>/csrc/*.cu`` behind a plain
``extern "C"`` launcher that enqueues on the caller's stream and returns
``cudaGetLastError()``.  At first use the source is compiled for Hopper
into ``build/repro_torch/`` at the root of the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

No ``--use_fast_math``: it would change ``sqrtf`` and division and break
parity with the plain versions.  The library name carries a hash of the
source, so an edited source is never served by a stale build.  A missing
``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
# src/repro_torch/kernels → the checkout root.
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = {
    "cell_rank": _PKG / "cell_rank" / "csrc" / "cell_rank.cu",
    "cell_list_force": _PKG / "cell_force" / "csrc" / "cell_list_force.cu",
    "cell_window_force": _PKG / "cell_force" / "csrc" / "cell_window_force.cu",
    "pairwise_force": _PKG / "pairwise_force" / "csrc" / "pairwise_force.cu",
    "diffusion3d": _PKG / "diffusion3d" / "csrc" / "diffusion3d.cu",
    "rmsnorm": _PKG / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_wgmma": _PKG / "flash_attention" / "csrc" / "flash_attention_wgmma.cu",
    "flash_attention_wgmma_d256": _PKG / "flash_attention" / "csrc" / "flash_attention_wgmma_d256.cu",
}


@dataclass
class BuildResult:
    name: str
    library: Path
    seconds: float          # 0.0 when an existing build was reused
    ptxas: str              # the -Xptxas -v register / shared-memory report


# Loaded libraries, keyed by kernel name: a process-wide cache of dlopen
# handles (loading twice would only map the same file again).
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch are built from source at first use"
        )
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, BuildResult]:
    """Compile the named kernels, one ``nvcc`` process each, all started
    together; returns each build's wall time and ptxas report."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    procs = {}
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists():
            results[name] = BuildResult(
                name, target, 0.0, log.read_text() if log.exists() else ""
            )
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            time.perf_counter(), tmp, target, log,
        )
    failures = []
    for name, (proc, t0, tmp, target, log) in procs.items():
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, target)
        results[name] = BuildResult(name, target, secs, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].library))
        _LOADED[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """Kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expects CUDA tensors, got one on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
