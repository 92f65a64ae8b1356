"""Explicit-seed random generators and dropout seed words.

Counterpart of ``paddle_tpu/core/random.py``. The JAX package hands out
keys from a process-global stateful generator; the port passes a
``torch.Generator`` made from an explicit seed to whatever draws (weight
init, sampling, dropout), so two engines or trainers never share a
stream by accident. Threefry and Philox give different numbers from the
same seed: tests that compare the packages make their inputs with numpy
instead.

Dropout draws two 32-bit seed words per call (:func:`seed_words`) from a
CPU generator, so a draw never waits on the card. They stand in for the
JAX package's ``jax.random.key_data(key)[:2]``: the keep bits are the
same function of the words in both packages (``ops/rng.py``), but the
words themselves come from another stream. A forward in training mode
takes its generator from :func:`dropout_generator`, which ``TrainStep``
and ``GPTForPretraining.forward(generator=...)`` enter.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

from .device import DeviceLike, resolve_device

__all__ = ["make_generator", "seed_words", "dropout_generator",
           "next_seed_words"]

_SCOPE = threading.local()


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g


def seed_words(generator: torch.Generator) -> Tuple[int, int]:
    """Two uint32 words ``(s0, s1)`` drawn from a CPU ``generator``."""
    if generator.device.type != "cpu":
        raise ValueError("seed words come from a CPU generator, so that a "
                         f"draw needs no device sync (got {generator.device})")
    w = torch.randint(0, 2 ** 32, (2,), generator=generator,
                      dtype=torch.int64)
    return int(w[0]), int(w[1])


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator) -> Iterator[None]:
    """Dropout inside this block draws its seed words from ``generator``."""
    stack = _SCOPE.__dict__.setdefault("stack", [])
    stack.append(generator)
    try:
        yield
    finally:
        stack.pop()


def next_seed_words() -> Tuple[int, int]:
    """Seed words for one dropout call, from the innermost
    :func:`dropout_generator`; raises outside of one."""
    stack = _SCOPE.__dict__.get("stack")
    g: Optional[torch.Generator] = stack[-1] if stack else None
    if g is None:
        raise RuntimeError(
            "dropout in training mode needs a generator: pass generator= "
            "to the model's forward, run it under TrainStep, or call "
            "model.eval()")
    return seed_words(g)
