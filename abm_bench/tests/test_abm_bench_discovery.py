"""A configuration, a traffic mix, a loop, a per-layer metric and a cell are
taken up from new files and entries alone; no module of the harness runs JAX or
the JAX package, and the references import nothing of the program."""

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest

from abm_bench.harness import cli, drive, spec

BENCH = Path(spec.BENCH_DIR)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in cli.FORBIDDEN, (path, name)


def test_the_references_import_nothing_of_the_program_or_the_harness():
    for path in (BENCH / "reference").glob("*.py"):
        names = _imports(path)
        assert not {n.split(".")[0] for n in names} & {"repro_torch", "repro"}, (path, names)
        bench = {n for n in names if n.split(".")[0] == "abm_bench"}
        assert bench <= {"abm_bench.reference"}, (path, bench)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"repro.core", "jax"} <= set(cli.forbidden_modules())


# A loop that no file of the benchmark has: every unit a fresh run of
# ``interval_steps`` from the one start.
RESTART = """
import time

from abm_bench.harness import drive


class Restart(drive.Solo):
    def setup(self):
        self.unit_steps = int(self.traffic["interval_steps"])
        start = self.make_starts(1)[0]
        self.built = self.build(start, observe=True)
        self.state0 = self.model.prepare(self.built, start)
        self.check_start(start, self.state0)
        t = time.perf_counter()
        self.built.run_jit(self.unit_steps, state=self.state0)
        self.warm_s = self.unit_s = time.perf_counter() - t
        self.runner_stats = dict(self.runner.stats)

    def run_unit(self, j, prev_end, keep):
        out, obs = self.built.run_jit(self.unit_steps, state=self.state0)
        agent_steps, failed = self.read(obs["kind_counts"], out.health)
        self.steps_done += self.unit_steps
        self.record(drive.Case(self.state0, out, self.unit_steps), keep)
        return drive.Unit(prev_end, time.perf_counter(), self.unit_steps, agent_steps, 0.0,
                          failed)

    def free(self):
        del self.built, self.state0


LOOP = Restart
"""


def test_a_new_config_mix_metric_and_cell_are_taken_up_from_files(tmp_path, tiny_root,
                                                                   cpu_threads):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    b = root / "abm_bench"
    # A configuration: its file, its model module and its reference.
    for sub, ext in (("configs", "json"), ("configs", "py"), ("reference", "py")):
        shutil.copy(b / sub / f"soma-tissue.{ext}", b / sub / f"soma-sparse.{ext}")
    cfg = json.loads((b / "configs/soma-sparse.json").read_text())
    cfg["density_per_um3"] = 0.0003
    (b / "configs/soma-sparse.json").write_text(json.dumps(cfg))
    # A traffic mix, and the loop it names: a file of its own.
    mix = json.loads((b / "traffic/long.json").read_text())
    mix.update(loop="restart", interval_steps=40)
    (b / "traffic/short.json").write_text(json.dumps(mix))
    (b / "loops/restart.py").write_text(RESTART)
    # A per-layer metric: a reader of its own.
    (b / "metrics/units_done.py").write_text("def read(ctx):\n    return len(ctx.units)\n")
    (b / "checks/soma-sparse.short.json").write_text(
        (b / "checks/soma-tissue.long.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="soma-sparse",
                                 file="abm_bench/configs/soma-sparse.json"))
    bench["workloads"].append({"name": "soma-sparse.short", "config": "soma-sparse",
                               "traffic": "short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "units_done", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "runner",
                               "moves": "agent_steps_per_s",
                               "workloads": ["soma-sparse.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("soma-sparse.short", root=root)
    assert cell.cfg["agents"] == round(0.0003 * 60.0 ** 3)
    assert cell.traffic["interval_steps"] == 40
    assert type(drive.loop_for(cell, 5, "cpu")).__name__ == "Restart"
    assert [m["name"] for m in cell.per_layer][-1] == "units_done"
    res = cli.run_cell("soma-sparse.short", 5, 0.5, True, device="cpu", root=root)
    assert res["correct"]
    assert res["metrics"]["units_done"]["value"] == res["attempted"]


def test_an_unknown_loop_is_refused(tmp_path, tiny_root):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    (root / "abm_bench/traffic/long.json").write_text(json.dumps({"loop": "open-loop", "space_um": 60.0}))
    cell = spec.find_cell("soma-tissue.long", root=root)
    with pytest.raises(ValueError, match="unknown loop"):
        drive.loop_for(cell, 1, "cpu")
