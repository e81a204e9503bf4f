"""``loop: jobs``: a closed loop of ``job_steps``-step simulations through
``BuiltSimulation.run_jit``, each from one of ``starts`` starts made at
set-up (in turn) with its own key from the seed; a job's time runs from the
last one's end to its results on the host.  Set-up runs a job from every
start, which captures the graphs."""

import dataclasses
import time

from abm_bench.harness import drive


class Jobs(drive.Solo):
    def setup(self):
        self.unit_steps = int(self.traffic["job_steps"])
        starts = self.make_starts(int(self.traffic["starts"]))
        t = time.perf_counter()
        self.built = self.build(starts[0], observe=True)
        others = [self.build(s, observe=False) for s in starts[1:]]
        drive.sync(self.device)
        self.build_s = time.perf_counter() - t
        self.states = [self.model.prepare(self.built, starts[0])]
        self.states += [self.model.prepare(b, s) for b, s in zip(others, starts[1:])]
        self.check_start(starts[0], self.states[0])
        del others
        t = time.perf_counter()
        for k in range(len(self.states)):
            out, obs = self.built.run_jit(self.unit_steps, state=self.job_input(k))
            self.read(obs["kind_counts"], out.health)
        self.warm_s = time.perf_counter() - t
        self.unit_s = self.warm_s / len(self.states)
        self.runner_stats = dict(self.runner.stats)

    def job_input(self, j: int):
        from repro_torch.core import prng

        base = self.states[j % len(self.states)]
        key = prng.PRNGKey(drive.unit_seed(self.seed, j), device=self.device)
        return dataclasses.replace(base, rng=key)

    def run_unit(self, j, prev_end, keep):
        t = time.perf_counter()
        state_in = self.job_input(j)
        t_run = time.perf_counter()
        out, obs = self.built.run_jit(self.unit_steps, state=state_in)
        t_read = time.perf_counter()
        agent_steps, failed = self.read(obs["kind_counts"], out.health)
        end = time.perf_counter()
        self.steps_done += self.unit_steps
        self.record(drive.Case(state_in=state_in, answer=out, steps=self.unit_steps), keep)
        return drive.Unit(start=prev_end, end=end, steps=self.unit_steps,
                          agent_steps=agent_steps, host_s=(t_run - t) + (end - t_read),
                          failed=failed)

    def free(self):
        del self.built, self.states
        self.cases, self.last_case = [], None


LOOP = Jobs
