"""Kernels: ``cell_rank``'s least time (the counts of ``harness/counts.py``
at the traced state) over its device time (its count, placement and rank
kernels)."""

from abm_bench.harness import counts


def read(ctx):
    return counts.roofline_pct(
        ctx.trace, ctx.cfg, "cell_rank", ("cell_rank_count", "cell_rank_alloc_fill",
                                          "cell_rank_rank"),
        lambda snap, cnt, n: counts.cell_rank(cnt, snap["position"].shape[0]))
