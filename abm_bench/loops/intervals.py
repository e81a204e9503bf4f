"""``loop: intervals``: one simulation run for the window through
``BuiltSimulation.run_jit`` in intervals of ``interval_steps``, each
continuing the last, the observed kind counts read at each interval's end.
Set-up runs one interval, which captures the graphs."""

import time

from abm_bench.harness import drive


class Intervals(drive.Solo):
    def setup(self):
        self.unit_steps = int(self.traffic["interval_steps"])
        start = self.make_starts(1)[0]
        t = time.perf_counter()
        self.built = self.build(start, observe=True)
        drive.sync(self.device)
        self.build_s = time.perf_counter() - t
        self.state0 = self.model.prepare(self.built, start)
        self.check_start(start, self.state0)
        t = time.perf_counter()
        state, obs = self.built.run_jit(self.unit_steps, state=self.state0)
        self.read(obs["kind_counts"], state.health)
        self.warm_s = self.unit_s = time.perf_counter() - t
        del state
        self.state = self.state0
        self.runner_stats = dict(self.runner.stats)

    def run_unit(self, j, prev_end, keep):
        state_in = self.state
        new, obs = self.built.run_jit(self.unit_steps, state=state_in)
        agent_steps, failed = self.read(obs["kind_counts"], new.health)
        end = time.perf_counter()
        self.steps_done += self.unit_steps
        self.record(drive.Case(state_in=state_in, answer=new, steps=self.unit_steps), keep)
        self.state = new
        return drive.Unit(start=prev_end, end=end, steps=self.unit_steps,
                          agent_steps=agent_steps, host_s=0.0, failed=failed)

    def free(self):
        del self.built, self.state, self.state0
        self.cases, self.last_case = [], None


LOOP = Intervals
