"""Runner: device milliseconds a traced step in the replayed graphs' observables
and ``record`` segments (the rows written, the commit into the static buffers).
"""

from abm_bench.harness import program_spans


def read(ctx):
    return program_spans.group_ms(ctx, "record")
