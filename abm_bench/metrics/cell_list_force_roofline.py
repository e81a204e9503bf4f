"""Kernels: ``cell_list_force``'s least time (the counts of
``harness/counts.py`` at the traced state) over its device time."""

from abm_bench.harness import counts


def read(ctx):
    cfg = ctx.cfg
    return counts.roofline_pct(
        ctx.trace, cfg, "cell_list_force", ("cell_list_force_kernel",),
        lambda snap, cnt, n: counts.cell_list_force(cnt, n, int(cfg["max_per_cell"]),
                                                    snap["position"].shape[0]))
