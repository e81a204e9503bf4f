"""Scheduler and ops: device milliseconds a traced step in the replayed graphs'
segments of ``op.forces``, ``op.boundary`` and ``op.static_flags`` (the op
maps taken at capture; ``harness/program_spans.py``)."""

from abm_bench.harness import program_spans


def read(ctx):
    return program_spans.group_ms(ctx, "mechanics")
