"""Device selection for the port's entry points: ``cuda`` unless the caller
asks for the CPU, and an error (never a fallback) when there is no card."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
