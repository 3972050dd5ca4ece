"""Device choice. Counterpart of paddle_tpu/core/place.py.

The port runs on the card unless the caller asks for the CPU: an entry
point's ``device=None`` means ``cuda``, and raises when no card is
present. It never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


class CUDAPlace:
    """A card, by index (Paddle's CUDAPlace)."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


class CPUPlace:
    """The host (Paddle's CPUPlace)."""

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card (``cuda``), raising RuntimeError when none is
    present; a place, a ``torch.device`` or a device string -> that
    device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda")
    if isinstance(device, (CUDAPlace, CPUPlace)):
        return device.torch_device
    return torch.device(device)


__all__ = ["CPUPlace", "CUDAPlace", "resolve_device"]
