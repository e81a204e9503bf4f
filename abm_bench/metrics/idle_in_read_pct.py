"""Runner: the share of the traced wall with the device idle while the host is
inside a ``runner.read`` span (a compiled run's device-to-host read: the
facade's start step, the host count, a chunk's divergence flag)."""

from abm_bench.harness import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx.trace, ("runner.read",), inside=True)
