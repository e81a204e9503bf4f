"""Runner: seconds the runner spent capturing CUDA graphs during set-up
(``Runner.stats["capture_s"]``)."""


def read(ctx):
    return ctx.capture_s
