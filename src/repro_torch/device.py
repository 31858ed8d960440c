"""Device resolution for the port's entry points.

The port is written for the card: an entry point given no device runs on
``cuda`` and raises when none is present. The CPU is used only when the
caller asks for it by name (the parity tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current ``cuda`` device (with its index, as a tensor
    there reports it); raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:  # as tensors report it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
