"""Device: the whole step's share of the card's roofline.  The least time
of a step is the larger of its least bytes (every declared agent attribute
and field read once and written once) at 3.35 TB/s and its counted
operations (12 a contact pair) at 67 TFLOP/s, each traced step counted at
its own input; their sum is divided by the traced units' wall time."""

from abm_bench.harness import counts, peaks


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.states or not tr.device or tr.window_s <= 0:
        return None
    _, _, n = counts.grid_of(ctx.cfg)
    least = 0.0
    for sessions in tr.states:
        n_bytes = sum(counts.state_bytes(s) for s in sessions)
        n_ops = sum(counts.PAIR_OPS * counts.box_pairs(counts.cell_counts(s, ctx.cfg), n)
                    for s in sessions)
        least += peaks.least_seconds(n_bytes, n_ops)
    return 100.0 * least / tr.window_s
