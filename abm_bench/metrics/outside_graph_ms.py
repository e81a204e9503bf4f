"""Runner: device milliseconds a traced step outside every replayed graph: the
copies into and out of a run, each chunk's saved copy and divergence reduce, and
the caller's operations."""

from abm_bench.harness import program_spans


def read(ctx):
    return program_spans.group_ms(ctx, "outside_graph")
