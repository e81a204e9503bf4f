"""Optimisers of the port.  ``pso``: the paper's §4.4.10 calibration of an
agent model's parameters (numpy only, a copy of ``repro.optim.pso``);
``adamw``: the LM trainer's AdamW; ``compression``: the error-fed int8
gradient all-reduce over the in-process mesh."""

from . import adamw, compression, pso  # noqa: F401
