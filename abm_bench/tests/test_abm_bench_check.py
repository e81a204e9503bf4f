"""``correct`` at the CPU's sizes: the program passes; the control (the
reference one precision below in the program's place) fails; and a run
with the timed path broken underneath fails, for each fault the cell can
have: a step that returns its state unchanged, half of a batch left out, an
answer altered where it is produced.  (No cell spans chips, so no exchange
can be left out.)"""

import dataclasses
import json

import pytest
import torch

from abm_bench.harness import check

CELLS = ("soma-tissue.long", "tumor-spheroid.jobs", "soma-tissue.sweep")


def _limits(root, workload):
    return json.loads((root / "abm_bench/checks" / f"{workload}.json").read_text())["limits"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_passes_and_the_control_fails(workload, run_tiny, tiny_root):
    res = run_tiny(workload, control=torch.bfloat16)
    assert res["correct"], res["checks"]
    assert res["checked"]["steps"] > 0
    ok, shown = check.judge(dict(res["control"], chain_off=0, start_off=0),
                            _limits(tiny_root, workload))
    assert not ok, shown


def _unchanged(monkeypatch):
    from repro_torch.core.schedule import Scheduler

    monkeypatch.setattr(Scheduler, "step_at", lambda self, state, step, branches=None: state)
    monkeypatch.setattr(Scheduler, "step_slots",
                        lambda self, state, live, steps, branches=None: state)


def _altered(monkeypatch):
    """Moves the first agent of the step's answer by 20 um."""
    from repro_torch.core.schedule import Scheduler

    def alter(state):
        pool = state.pool
        shift = torch.zeros_like(pool.position)
        shift[0] = 20.0
        return dataclasses.replace(state, pool=pool.replace(position=pool.position + shift))

    step_at, step_slots = Scheduler.step_at, Scheduler.step_slots
    monkeypatch.setattr(Scheduler, "step_at",
                        lambda self, *a, **k: alter(step_at(self, *a, **k)))
    monkeypatch.setattr(Scheduler, "step_slots",
                        lambda self, *a, **k: alter(step_slots(self, *a, **k)))


def _half_batch(monkeypatch):
    """Steps the first half of a batch's sessions and leaves the rest."""
    from repro_torch.core.grid import bool_mask
    from repro_torch.core.schedule import Scheduler
    from repro_torch.core.slots import select, to_flat, to_slots

    step_slots = Scheduler.step_slots

    def half(self, state, live, steps, branches=None):
        new = step_slots(self, state, live, steps, branches=branches)
        b = len(live)
        keep = bool_mask([i < b // 2 for i in range(b)], state.step.device)
        return to_flat(select(keep, to_slots(new), to_slots(state)))

    monkeypatch.setattr(Scheduler, "step_slots", half)


FAULTS = [(w, f) for w in CELLS for f in ("unchanged", "altered")]
FAULTS.append(("soma-tissue.sweep", "half_batch"))


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault, run_tiny, monkeypatch):
    {"unchanged": _unchanged, "altered": _altered, "half_batch": _half_batch}[fault](monkeypatch)
    res = run_tiny(workload)
    assert not res["correct"], res["checks"]


def test_a_perturbed_state_fails_the_comparison(tiny_root):
    from abm_bench.harness import spec

    cell = spec.find_cell("tumor-spheroid.jobs", root=tiny_root)
    limits = _limits(tiny_root, "tumor-spheroid.jobs")
    gen = torch.Generator().manual_seed(3)
    c = 64
    state = {"position": 40 + 60 * torch.rand((c, 3), generator=gen),
             "diameter": torch.full((c,), 15.0), "kind": torch.zeros(c, dtype=torch.int32),
             "age": torch.full((c,), 30.0), "alive": torch.arange(c) < 48,
             "static": torch.zeros(c, dtype=torch.bool), "attrs": {"radial": torch.zeros(c)},
             "fields": {}, "overflow": 0, "rng": torch.tensor([0, 7]), "step": 3,
             "health": {k: 0 for k in ("pool_overflow", "migrate_overflow", "halo_overflow",
                                       "cell_overflow_steps", "nonfinite_agents",
                                       "nonfinite_steps")}}
    want = cell.reference.step(cell.cfg, state)
    obs = cell.reference.observed(cell.cfg, want)
    same = check.compare(want, want, obs, obs)
    assert check.judge(dict(same, chain_off=0, start_off=0), limits)[0]
    moved = dict(want, position=want["position"].clone())
    moved["position"][5] += 20.0
    assert not check.judge(dict(check.compare(moved, want, obs, obs), chain_off=0,
                                start_off=0), limits)[0]
    killed = dict(want, alive=want["alive"].clone())
    killed["alive"][0] = False
    killed_obs = cell.reference.observed(cell.cfg, killed)
    assert not check.judge(dict(check.compare(killed, want, killed_obs, obs), chain_off=0,
                                start_off=0), limits)[0]


def test_a_window_that_drops_agents_is_not_correct(tiny_root, tmp_path, cpu_threads):
    """The spheroid with no free row: every birth is dropped (pool
    overflow).  The reference, following the program's steps, drops the same
    ones, so only the units' telemetry shows it."""
    import shutil

    from abm_bench.harness import cli

    root = tmp_path / "full"
    shutil.copytree(tiny_root, root)
    path = root / "abm_bench/configs/tumor-spheroid.json"
    cfg = json.loads(path.read_text())
    cfg["capacity"] = cfg["cells"]
    path.write_text(json.dumps(cfg))
    res = cli.run_cell("tumor-spheroid.jobs", 99, 1.0, False, device="cpu", root=root)
    assert res["failed"] > 0
    assert res["checks"]["unclean_units"] == {"value": res["failed"], "limit": 0}
    assert not res["correct"], res["checks"]
