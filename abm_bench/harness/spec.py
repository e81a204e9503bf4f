"""Discovery: everything of a cell is found by the names ``BENCHMARK.json`` gives.

* a configuration ``<config>``: its file (``configs/<config>.json``, the
  configuration as run), its model module ``configs/<config>.py`` and its
  plain reference ``reference/<config>.py``;
* a traffic mix ``<traffic>``: ``traffic/<traffic>.json``, the parameters
  of what users send, read by the loop its ``loop`` key names;
* a loop ``<loop>``: ``loops/<loop>.py``, whose ``LOOP`` drives the
  program (``harness/drive.py`` holds what every loop shares);
* a per-layer metric ``<metric>``: its reader ``metrics/<metric>.py``;
* a cell's limits for ``correct``: ``checks/<workload>.json``.

A later change adds a configuration, a mix, a loop, a metric or a cell by
adding such files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import zlib
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """A module from its file, under a private name made from ``name`` and
    the file's place (files here are named after cells and configurations,
    which are not identifiers)."""
    path = Path(path).resolve()
    name = f"{name}_{zlib.crc32(str(path).encode()):08x}"
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ident(text: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in text)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    workload: dict
    config_entry: dict
    cfg: dict
    traffic: dict
    model: object
    reference: object
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           f"abm_bench_metric_{ident(name)}")


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def find_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, its files loaded."""
    bench = load_benchmark(root) if bench is None else bench
    bench_dir = Path(root) / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    workload = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[workload["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{workload['traffic']}.json").read_text())
    tag = ident(entry["name"])
    model = load_module(bench_dir / "configs" / f"{entry['name']}.py", f"abm_bench_config_{tag}")
    reference = load_module(bench_dir / "reference" / f"{entry['name']}.py",
                            f"abm_bench_reference_{tag}")
    in_cell = lambda m: "workloads" not in m or name in m["workloads"]
    return Cell(name=name, workload=workload, config_entry=entry,
                cfg=model.derived(cfg, traffic), traffic=traffic, model=model,
                reference=reference,
                end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
                per_layer=[m for m in bench["per_layer"] if in_cell(m)],
                bench_dir=bench_dir)
