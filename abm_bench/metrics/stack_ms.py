"""Host side of a job: host milliseconds a call of ``BatchedSimulation.stack``
(the sweep's slot starts stacked into a batch) over the window
(``Runner.stats["stack_s"]`` over ``stacks``, the batched runner's)."""


def read(ctx):
    ws = ctx.window_stats
    if "stack_s" not in ws or not ws.get("stacks"):
        return None
    return 1e3 * ws["stack_s"] / ws["stacks"]
