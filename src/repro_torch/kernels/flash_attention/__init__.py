"""flash_attention kernel package."""
from . import kernel, ops, ref  # noqa: F401
