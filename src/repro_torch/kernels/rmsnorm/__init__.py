"""rmsnorm kernel package."""
from . import kernel, ops, ref  # noqa: F401
