"""``loop: sweep``: a closed loop of batched jobs through
``BuiltSimulation.batched().run_jit``, ``slots`` simulations a job, each
from one of ``starts`` starts made at set-up with its own key and, where the
mix says ``vary``, its own initial level of a field drawn from the seed.
Set-up runs two jobs, which capture the graphs."""

import dataclasses
import time

import numpy as np
import torch

from abm_bench.harness import check, drive


class Sweep(drive.Loop):
    def setup(self):
        self.unit_steps, self.slots = int(self.traffic["job_steps"]), int(self.traffic["slots"])
        starts = self.make_starts(int(self.traffic["starts"]))
        t = time.perf_counter()
        built = [self.build(s, observe=True) for s in starts]
        self.eng = built[0].batched()
        drive.sync(self.device)
        self.build_s = time.perf_counter() - t
        self.states = [self.model.prepare(b, s) for b, s in zip(built, starts)]
        self.check_start(starts[0], self.states[0])
        del built
        t = time.perf_counter()
        for k in range(2):
            out, obs, _ = self.eng.run_jit(self.job_input(k), self.unit_steps)
            self.read(obs["kind_counts"], out.states.health)
        self.warm_s = time.perf_counter() - t
        self.unit_s = self.warm_s / 2
        self.runner_stats = dict(self.runner.stats)

    @property
    def runner(self):
        return self.eng._jitted

    def slot_state(self, j: int, b: int):
        from repro_torch.core import prng

        base = self.states[(j * self.slots + b) % len(self.states)]
        state = dataclasses.replace(
            base, rng=prng.PRNGKey(drive.unit_seed(self.seed, j, b), device=self.device))
        vary = self.traffic.get("vary")
        if vary:
            rng = np.random.default_rng([self.seed % (1 << 63), j, b])
            level = float(rng.uniform(vary["low"], vary["high"]))
            grid = state.grids[vary["field"]]
            grids = dict(state.grids)
            grids[vary["field"]] = dataclasses.replace(
                grid, concentration=torch.full_like(grid.concentration, level))
            state = dataclasses.replace(state, grids=grids)
        return state

    def job_input(self, j: int):
        return self.eng.stack([self.slot_state(j, b) for b in range(self.slots)])

    def run_unit(self, j, prev_end, keep):
        t = time.perf_counter()
        bstate = self.job_input(j)
        t_run = time.perf_counter()
        out, obs, _ = self.eng.run_jit(bstate, self.unit_steps)
        t_read = time.perf_counter()
        agent_steps, failed = self.read(obs["kind_counts"], out.states.health)
        end = time.perf_counter()
        self.steps_done += self.unit_steps
        self.record(drive.Case(state_in=bstate, answer=out, steps=self.unit_steps), keep)
        return drive.Unit(start=prev_end, end=end, steps=self.unit_steps,
                          agent_steps=agent_steps, host_s=(t_run - t) + (end - t_read),
                          failed=failed)

    def step_once(self, state):
        out, obs, _ = self.eng.run_jit(state, 1)
        return out, obs

    def sessions(self, state, obs=None) -> list:
        from repro_torch.core.batch import slot_state

        return [(slot_state(state, b),
                 {"kind_counts": obs["kind_counts"][b, 0].cpu()} if obs else None)
                for b in range(self.slots)]

    def ends_differ(self, a, b) -> int:
        return check.leaves_differ(a.states, b.states)

    def counter_at(self, case) -> int:
        return int(case.state_in.states.step[0])

    def free(self):
        del self.eng, self.states
        self.cases, self.last_case = [], None


LOOP = Sweep
