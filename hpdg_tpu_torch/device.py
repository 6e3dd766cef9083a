"""Explicit device resolution: the port runs on the card unless asked."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the current CUDA device; a string or ``torch.device``
    -> that device.

    Without a card ``None`` raises: CPU callers pass ``device="cpu"``.
    A bare ``"cuda"`` is pinned to the current card index so that
    tensors made for it compare equal by device.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() "
                               "is False): pass device=\"cpu\" to run on "
                               "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested, but "
                               "torch.cuda.is_available() is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
