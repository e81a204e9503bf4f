"""Facade: seconds to build the model (``Simulation(...).build()`` of every
start, ending in a synchronise), on the host clock."""


def read(ctx):
    return ctx.build_s
