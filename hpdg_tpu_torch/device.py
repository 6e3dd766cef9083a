"""Explicit device resolution: the port has no global default device."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the CPU; a string or ``torch.device`` -> that device.

    A bare ``"cuda"`` is pinned to the current card index so that
    tensors made for it compare equal by device.
    """
    if device is None:
        return torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested, but "
                               "torch.cuda.is_available() is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
