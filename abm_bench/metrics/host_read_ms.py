"""Runner: host milliseconds a unit blocked in the compiled runs' device-to-host
reads (the facade's start step, the host count, each chunk's divergence flag:
``Runner.stats["read_s"]``), over the window's units."""


def read(ctx):
    ws = ctx.window_stats
    if "read_s" not in ws or not ctx.units:
        return None
    return 1e3 * ws["read_s"] / len(ctx.units)
