"""Runner: the share of the window's steps run eagerly instead of replayed
(``Runner.stats["eager_steps"]``: a missing graph or a rolled-back chunk)."""


def read(ctx):
    if not ctx.steps:
        return None
    return 100.0 * ctx.window_stats.get("eager_steps", 0) / ctx.steps
