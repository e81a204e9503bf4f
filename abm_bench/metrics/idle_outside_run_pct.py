"""Host side of a job: the share of the traced wall with the device idle while
the host is outside every ``facade.run_jit`` and ``batch.run_jit`` span (the
caller's work between compiled runs)."""

from abm_bench.harness import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx.trace, program_spans.RUN_SPANS, inside=False)
