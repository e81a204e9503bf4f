"""Kernels: ``diffusion3d``'s least time (one field read and written once,
``harness/counts.py``) over its device time."""

from abm_bench.harness import counts


def read(ctx):
    def work(snap, cnt, n):
        field = next(iter(snap["fields"].values()), None)
        return counts.diffusion(field.numel()) if field is not None else (0, 0)

    return counts.roofline_pct(ctx.trace, ctx.cfg, "diffusion3d", ("diffusion3d_kernel",), work)
