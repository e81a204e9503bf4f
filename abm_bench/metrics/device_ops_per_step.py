"""Scheduler and ops: device operations (kernels, copies, memsets) a step
in the traced units, replayed graphs included."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.steps or not tr.device:
        return None
    return len(tr.device) / tr.steps
