"""Optimisers of the port.  ``pso``: the paper's §4.4.10 calibration of an
agent model's parameters (numpy only, a copy of ``repro.optim.pso``)."""

from . import pso  # noqa: F401
