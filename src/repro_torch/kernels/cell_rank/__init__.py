"""cell_rank kernel package."""
from . import kernel, ops, ref  # noqa: F401
