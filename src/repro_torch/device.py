"""Where the port's entry points run: the CUDA device unless the caller
names another.  Nothing falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller names another; raises when
    CUDA is asked for (or implied) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
