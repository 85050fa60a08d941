"""The device rule of the package's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means the card: entry points run on CUDA unless the caller names
    another device (``device="cpu"``, as the tests do). With no card and no explicit
    device this raises; it never falls back to the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" names the current card: give it its index, so that a tensor's
            # device (always indexed) compares equal to it
            return torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
