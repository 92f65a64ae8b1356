"""Device resolution for the PyTorch port.

Counterpart of the device part of ``paddle_tpu/core/flags.py``: where the
JAX package lets XLA pick its backend, the port names its device
explicitly. Every entry point runs on the CUDA card unless the caller
asks for the CPU by name; a machine without a card raises instead of
quietly running the port on the host.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); ``"cpu"`` only when
    asked for; any CUDA device is checked for presence."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "present; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
