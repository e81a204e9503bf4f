"""Runner: the compiled runs' device-to-host reads a unit (the facade's start
step, the host count, each chunk's divergence flag: ``Runner.stats["reads"]``),
over the window's units."""


def read(ctx):
    ws = ctx.window_stats
    if "reads" not in ws or not ctx.units:
        return None
    return ws["reads"] / len(ctx.units)
