"""Device policy: the card unless the caller asks for the CPU.

There is no silent fallback.  A run that finds no card fails here, at the
entry point, instead of quietly running the plain PyTorch versions of the
kernels on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` / ``"cuda"`` → ``cuda:0`` (raises without a card);
    ``"cpu"`` → the host; any other ``torch.device`` spec is passed through
    after the same card check."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
