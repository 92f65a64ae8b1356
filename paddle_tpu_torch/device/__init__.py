"""``paddle.device``: counterpart of ``paddle_tpu/device/__init__.py``
(``set_device`` / ``get_device``, the device lists, and the ``cuda``
namespace), on torch's view of the card. ``cuda``'s memory figures are
the caching allocator's (``torch.cuda.memory_allocated`` and the rest);
they read 0 where no card is present, as the JAX shims do on a backend
without allocator statistics."""

from __future__ import annotations

import torch

from ..core.device import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa
                           NPUPlace, Place, TPUPlace, XPUPlace, device_count,
                           get_device, is_compiled_with_cuda,
                           is_compiled_with_tpu, set_device)

__all__ = ["set_device", "get_device", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "cuda"]


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []


class cuda:
    """``paddle.device.cuda``: the card's count, sync, cache and memory
    counters."""

    @staticmethod
    def _live() -> bool:
        return torch.cuda.is_available()

    @staticmethod
    def device_count() -> int:
        return device_count()

    @staticmethod
    def synchronize(device=None) -> None:
        if cuda._live():
            torch.cuda.synchronize(device)

    @staticmethod
    def empty_cache() -> None:
        if cuda._live():
            torch.cuda.empty_cache()

    @staticmethod
    def memory_allocated(device=None) -> int:
        return torch.cuda.memory_allocated(device) if cuda._live() else 0

    @staticmethod
    def max_memory_allocated(device=None) -> int:
        return torch.cuda.max_memory_allocated(device) if cuda._live() \
            else 0

    @staticmethod
    def reset_max_memory_allocated(device=None) -> None:
        if cuda._live():
            torch.cuda.reset_peak_memory_stats(device)

    @staticmethod
    def memory_reserved(device=None) -> int:
        return torch.cuda.memory_reserved(device) if cuda._live() else 0

    @staticmethod
    def max_memory_reserved(device=None) -> int:
        return torch.cuda.max_memory_reserved(device) if cuda._live() \
            else 0
