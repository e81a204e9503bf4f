from .checkpoint import (  # noqa: F401
    latest_step,
    list_steps,
    read_manifest,
    restore,
    save,
)
