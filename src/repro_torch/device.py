"""Device policy: the card unless the caller asks for the CPU or the meta
device.

There is no silent fallback.  A run that finds no card fails here, at the
entry point, instead of quietly running the plain PyTorch versions of the
kernels on the host.

The meta device is taken only when asked for by name (``"meta"``).  Its
tensors have shapes, dtypes and strides and no storage: the dry-run
(``launch/dryrun.py``) builds parameters, optimizer state, batches and decode
caches on it to plan what a step holds and does, as the reference plans
against ``ShapeDtypeStruct``s on fake host devices.  It is not a fallback:
no step's arithmetic runs there, and nothing that runs on meta is a result.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` / ``"cuda"`` → ``cuda:0`` (raises without a card);
    ``"cpu"`` → the host; ``"meta"`` → the meta device (shapes only); any
    other ``torch.device`` spec is passed through after the same card
    check."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda', 'cpu' or 'meta'")
    return dev
