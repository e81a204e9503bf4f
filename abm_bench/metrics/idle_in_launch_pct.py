"""Runner: the share of the traced wall with the device idle while the host is
inside a ``runner.replay`` span (launching a captured step)."""

from abm_bench.harness import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx.trace, ("runner.replay",), inside=True)
