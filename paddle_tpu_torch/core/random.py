"""Explicit-seed random generators.

Counterpart of ``paddle_tpu/core/random.py``. The JAX package hands out
keys from a process-global stateful generator; the port passes a
``torch.Generator`` made from an explicit seed to whatever draws (weight
init, sampling), so two engines never share a stream by accident.
Threefry and Philox give different numbers from the same seed: tests
that compare the packages make their inputs with numpy instead.
"""

from __future__ import annotations

import torch

from .device import DeviceLike, resolve_device

__all__ = ["make_generator"]


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
