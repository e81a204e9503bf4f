"""Fixtures of the benchmark's own tests: a copy of the benchmark at sizes
the CPU runs in seconds, and a run of a cell there."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# The CPU's sizes: a 60 um soma tissue (130 agents), a 200-cell spheroid in
# a 144 um space, sweeps of 3 slots; the loops and checks as on the card.
TINY = {
    "abm_bench/traffic/long.json": {"space_um": 60.0, "interval_steps": 20},
    "abm_bench/traffic/jobs.json": {"job_steps": 9, "starts": 2},
    "abm_bench/traffic/sweep.json": {"space_um": 60.0, "slots": 3, "job_steps": 5,
                                     "starts": 2},
    "abm_bench/configs/tumor-spheroid.json": {"cells": 200, "capacity": 256,
                                              "space": [0.0, 144.0]},
}


def tiny_copy(dst: Path) -> Path:
    """The benchmark under ``dst`` with the CPU's sizes."""
    shutil.copytree(ROOT / "abm_bench", dst / "abm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for rel, change in TINY.items():
        path = dst / rel
        data = json.loads(path.read_text())
        data.update(change)
        path.write_text(json.dumps(data))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cpu_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def run_tiny(tiny_root, cpu_threads):
    """``run(workload, **kw)``: one run of a cell of the CPU copy."""
    from abm_bench.harness import cli

    def run(workload: str, seed: int = 123456789012, seconds: float = 1.0, **kw) -> dict:
        return cli.run_cell(workload, seed, seconds, False, device="cpu", root=tiny_root, **kw)

    return run
