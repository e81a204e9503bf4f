"""Kernels: ``cell_window_force``'s least time (the counts of
``harness/counts.py`` at the traced state) over its device time (its two
kernels: the cell spans and the window walk)."""

from abm_bench.harness import counts


def read(ctx):
    return counts.roofline_pct(
        ctx.trace, ctx.cfg, "cell_window_force", ("cell_span_kernel", "window_force_kernel"),
        lambda snap, cnt, n: counts.cell_window_force(cnt, n, snap["position"].shape[0]))
