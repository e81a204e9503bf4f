"""Runner: host milliseconds inside a replay of a captured step (the graph
launch), over the window (``Runner.stats["replay_s"]`` over ``replays``)."""


def read(ctx):
    ws = ctx.window_stats
    if "replay_s" not in ws or not ws.get("replays"):
        return None
    return 1e3 * ws["replay_s"] / ws["replays"]
