"""What every loop shares; the loops themselves are files of their own.

A traffic mix's ``loop`` key names a file ``loops/<loop>.py`` whose
``LOOP`` is a subclass of ``Loop`` here (``Solo`` for a loop over one
program state at a time).  A loop makes the starts and builds the model at
set-up, runs every shape once so that the runner captures its graphs (the
window captures nothing), and then runs units (intervals or jobs) through
the program's compiled entry.  Every unit records its host-clock span, the
agent-steps it completed (the live agents of every step, from the kind
counts the harness registers as an observable at every step), the host's
own time around the call, and whether its telemetry came back clean.

After the window a unit can be stepped through again, one step a call of
the same entry (``replay``): the check does so for its sampled units, and a
traced run for its traced units, to count the work of every traced step
from that step's own input.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from . import check as _check
from . import counts as _counts
from . import spec as _spec
from . import trace as _trace

# The traced units, and the units the check replays, cover about this many
# steps (at least one unit).
SPAN_STEPS = 80


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def unit_seed(seed: int, unit: int, slot: int = 0) -> int:
    """A key seed for a job (and a slot of it), fixed by the run's seed."""
    return (int(seed) * 0x9E3779B1 + unit * 0x85EBCA77 + slot * 0xC2B2AE3D + 1) % (1 << 62)


@dataclasses.dataclass
class Unit:
    start: float
    end: float
    steps: int
    agent_steps: int
    host_s: float
    failed: bool


@dataclasses.dataclass(eq=False)
class Case:
    """A unit of the window kept for after it: its input, the window's
    answer and the steps between them."""

    state_in: object
    answer: object
    steps: int


class Loop:
    """The cell, the seed, the device, the spans; the window; the replay.

    A subclass sets ``unit_steps``, ``build_s``, ``warm_s``, ``unit_s`` and
    ``runner_stats`` in ``setup()`` and gives ``run_unit``, ``runner``,
    ``step_once``, ``sessions``, ``ends_differ``, ``counter_at`` and
    ``free``."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.traffic, self.model = cell.cfg, cell.traffic, cell.model
        self.units: list = []
        self.cases: list = []
        self.trace_cases: list = []
        self.last_case = None
        self.trace = None
        self.build_s = 0.0
        self.start_off = None
        self.steps_done = 0
        self.extras = {}

    # -- pieces -----------------------------------------------------------------

    def make_starts(self, count: int) -> list:
        starts = self.model.starts(self.cfg, self.traffic, self.seed, self.device, count)
        self.extras = self.model.setup(self.cfg, self.traffic, starts, self.device)
        return starts

    def build(self, start, observe: bool):
        sim = self.model.simulation(self.cfg, self.traffic, start, self.seed, self.device,
                                    **self.extras)
        if observe:
            sim = sim.observe_kinds("kind_counts", frequency=1, n_kinds=int(self.cfg["kinds"]))
        return sim.build()

    def check_start(self, start, state) -> None:
        self.start_off = self.model.start_mismatches(self.cfg, start, _check.snapshot(state))

    @staticmethod
    def read(counts: torch.Tensor, health) -> tuple:
        """One device-to-host read: the agent-steps of a unit and whether its
        telemetry is clean."""
        bad = torch.stack([health.nonfinite_steps.reshape(-1), health.cell_overflow_steps.reshape(-1),
                           health.pool_overflow.reshape(-1)]).sum()
        vals = torch.stack([counts.to(torch.int64).sum(), bad.to(torch.int64)]).tolist()
        return int(vals[0]), vals[1] > 0

    def record(self, case: Case, keep: bool) -> None:
        """Hold a unit's input and answer for the check: the sampled ones,
        and the last one (which stands in where the window ends early)."""
        self.last_case = case
        if keep:
            self.cases.append(case)

    def span_units(self) -> int:
        """Units that cover about ``SPAN_STEPS`` steps."""
        return max(1, -(-SPAN_STEPS // int(self.unit_steps)))

    def expected_units(self, seconds: float) -> int:
        """A safe count of the units a window reaches, from the warm-up's
        unit time (which includes the captures)."""
        return int(0.6 * seconds / max(self.unit_s, 1e-3))

    def sampled(self, expected: int, count: int) -> list:
        """``count`` unit indices drawn from the seed among the first
        ``expected`` of the window."""
        pool = list(range(max(int(expected), 1)))
        return sorted(random.Random(self.seed).sample(pool, min(count, len(pool))))

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, trace: bool):
        """Run units until ``seconds`` have passed; the last unit ends the
        window.  With ``trace``, the units after the first that cover
        ``SPAN_STEPS`` steps are run under the profiler, and the window is
        lengthened by the time the profiler took, so that as many units run
        untraced as in a plain run.  The units kept for the check, as many,
        are drawn from the seed among those the window is expected to reach;
        where it reaches fewer, its last unit stands in."""
        n_trace = self.span_units() if trace else 0
        want = self.span_units()
        keep = set(self.sampled(self.expected_units(seconds), want))
        t0 = time.perf_counter()
        prev_end, traced_s = t0, 0.0
        j = 0
        while True:
            if n_trace and j == 1:
                t = time.perf_counter()
                self._traced(j, n_trace, keep, prev_end)
                traced_s = time.perf_counter() - t
                j += n_trace
                prev_end = self.units[-1].end
            else:
                self.units.append(self.run_unit(j, prev_end, j in keep))
                prev_end = self.units[-1].end
                j += 1
            if prev_end - t0 - traced_s >= seconds:
                break
        if len(self.cases) < want and self.last_case not in self.cases:
            self.cases.append(self.last_case)
        return t0, prev_end

    def _traced(self, j, n, keep, prev_end):
        box = []

        def body():
            end = prev_end
            for i in range(j, j + n):
                box.append(self.run_unit(i, end, i in keep))
                self.trace_cases.append(self.last_case)
                end = box[-1].end

        _, self.trace = _trace.traced(body, lambda: self.steps_done, _launches)
        self.units.extend(box)

    # -- after the window -------------------------------------------------------

    def replay(self, case: Case, visit) -> int:
        """The case's unit again, one step a call of the same entry;
        ``visit(offset, state before, state after, observed)`` at every
        step.  Returns the leaves in which the replay's end differs from the
        window's answer."""
        s = case.state_in
        for i in range(case.steps):
            out, obs = self.step_once(s)
            visit(i, s, out, obs)
            s = out
        return self.ends_differ(s, case.answer)

    def count_traced(self) -> None:
        """The trace's ``states``: for every traced step, the work view
        (``counts.work_view``) of each session's input, stepped through
        again from each traced unit's own input."""
        steps = []

        def visit(i, before, after, obs):
            steps.append([_counts.work_view(_check.snapshot(x), self.cfg)
                          for x, _ in self.sessions(before)])

        off = sum(self.replay(case, visit) for case in self.trace_cases)
        self.trace.states = steps if off == 0 else []
        self.trace_cases = []


class Solo(Loop):
    """A loop over one program state at a time (``self.built``, a
    ``BuiltSimulation``)."""

    @property
    def runner(self):
        return self.built._jitted

    def step_once(self, state):
        return self.built.run_jit(1, state=state)

    def sessions(self, state, obs=None) -> list:
        return [(state, {"kind_counts": obs["kind_counts"][0].cpu()} if obs else None)]

    def ends_differ(self, a, b) -> int:
        return _check.leaves_differ(a, b)

    def counter_at(self, case: Case) -> int:
        return int(case.state_in.step)


def _launches() -> dict:
    from repro_torch import kernels

    return dict(kernels.read_launches())


def loop_for(cell, seed: int, device) -> Loop:
    """The loop the cell's traffic names, from ``loops/<loop>.py``."""
    kind = str(cell.traffic["loop"])
    path = cell.bench_dir / "loops" / f"{kind}.py"
    if not path.is_file():
        have = sorted(p.stem for p in (cell.bench_dir / "loops").glob("*.py"))
        raise ValueError(f"traffic {cell.workload['traffic']!r}: unknown loop {kind!r} "
                         f"(no {path.name} under loops/; there are {have})")
    mod = _spec.load_module(path, f"abm_bench_loop_{_spec.ident(kind)}")
    return mod.LOOP(cell, seed, device)
