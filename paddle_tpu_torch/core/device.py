"""Device resolution for the PyTorch port.

Counterpart of the device part of ``paddle_tpu/core/flags.py``: where the
JAX package lets XLA pick its backend, the port names its device
explicitly. Every entry point runs on the CUDA card unless the caller
asks for the CPU by name; a machine without a card raises instead of
quietly running the port on the host.

The eager API's half (``paddle_tpu/core/device.py``): :func:`set_device`
names the process's default device, which :func:`resolve_device` takes
for ``None`` (``set_device("cpu")`` is asking for the CPU by name), and
the ``Place`` names. ``CUDAPlace`` is the card; the TPU and NPU names
the JAX package aliases to its accelerator are aliases of it here.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "TPUPlace", "NPUPlace", "XPUPlace",
           "set_device", "get_device", "device_count", "default_place",
           "set_device_default",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the :func:`set_device` default, else ``cuda`` (raises
    without a card); ``"cpu"`` only when asked for; any CUDA device is
    checked for presence. A ``Place`` names its device."""
    if isinstance(device, Place):
        device = device.torch_device
    if device is None and _DEFAULT_DEVICE:
        device = _DEFAULT_DEVICE[0].torch_device
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


class Place:
    """A device place: ``Place("gpu", 0)``, ``Place("cpu")``."""

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.index == other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    @property
    def torch_device(self) -> torch.device:
        if self.kind == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.index)


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, index: int = 0):
        super().__init__("gpu", index)


CUDAPinnedPlace = CPUPlace
TPUPlace = CUDAPlace
NPUPlace = CUDAPlace
XPUPlace = CUDAPlace

_DEFAULT_DEVICE: list = []

_KINDS = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu", "tpu": "gpu",
          "npu": "gpu", "xpu": "gpu"}


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place("cpu") if device.type == "cpu" else \
            Place("gpu", device.index or 0)
    kind, _, idx = str(device).partition(":")
    if kind not in _KINDS:
        raise ValueError(f"unsupported device {device!r}; use 'cpu' or "
                         "'gpu[:i]'")
    return Place(_KINDS[kind], int(idx or 0))


def set_device(device) -> Place:
    """Make ``device`` (``"cpu"``, ``"gpu"``, ``"gpu:0"``, a ``Place``)
    the default for ``to_tensor``, the creation functions and every
    entry point given no device; a card that is not there raises."""
    place = _parse(device)
    resolve_device(place.torch_device)
    _DEFAULT_DEVICE[:] = [place]
    return place


def default_place() -> Place:
    """The :func:`set_device` place, else the card (``gpu:0``)."""
    return _DEFAULT_DEVICE[0] if _DEFAULT_DEVICE else Place("gpu", 0)


def set_device_default():
    """The :func:`set_device` device, or None when none was set."""
    return _DEFAULT_DEVICE[0].torch_device if _DEFAULT_DEVICE else None


def get_device() -> str:
    place = default_place()
    return f"{place.kind}:{place.index}"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False
