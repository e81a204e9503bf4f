"""TeraAgent on PyTorch + CUDA: the agent engine of ``repro`` ported to an
NVIDIA H100.

The package mirrors the JAX reference's layout (``core/``,
``kernels/<name>/{ref,ops,kernel}.py``) and imports neither ``jax`` nor
anything of ``repro``.  The model API is re-exported lazily, as in the
reference: ``from repro_torch import Simulation``.

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""

_API = ("Simulation", "BuiltSimulation", "Observable")

__all__ = list(_API)
__version__ = "0.1.0"


def __getattr__(name: str):
    if name in _API:
        from repro_torch.core import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
