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

A data-parallel rank holds batch rows ``b0 .. b0 + B/dp - 1`` of the
global batch; it enters the generator with ``batch_base=b0``
(:func:`dropout_batch_base`), and the dropouts hash those rows'
absolute coordinates, so every rank draws its slice of the
single-process masks (``ops/rng.py``, the kernels' base offsets).
:func:`dropout_state` and :func:`replay_dropout_state` let activation
recompute (``distributed.fleet.utils.recompute``) replay a segment's
seed words: ``torch.utils.checkpoint`` restores torch's own generators
only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

from .device import DeviceLike, resolve_device

__all__ = ["make_generator", "seed_words", "dropout_generator",
           "next_seed_words", "dropout_batch_base", "dropout_state",
           "replay_dropout_state"]

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
def dropout_generator(generator: torch.Generator,
                      batch_base: int = 0) -> Iterator[None]:
    """Dropout inside this block draws its seed words from ``generator``;
    its tensors are batch rows ``batch_base..`` of a larger batch."""
    stack = _SCOPE.__dict__.setdefault("stack", [])
    stack.append((generator, int(batch_base)))
    try:
        yield
    finally:
        stack.pop()


def _top():
    stack = _SCOPE.__dict__.get("stack")
    return stack[-1] if stack else None


def dropout_batch_base() -> int:
    """The global index of the first batch row of the tensors the active
    :func:`dropout_generator` drops (0 outside of one)."""
    top = _top()
    return top[1] if top is not None else 0


def dropout_state():
    """The active generator's state and batch base, or None outside a
    :func:`dropout_generator` (what :func:`replay_dropout_state` takes)."""
    top = _top()
    if top is None:
        return None
    return top[0].get_state(), top[1]


@contextlib.contextmanager
def replay_dropout_state(state) -> Iterator[None]:
    """Dropout inside this block draws the seed words that the
    generator of :func:`dropout_state` drew from its saved state, from a
    copy: the original generator does not move."""
    if state is None:
        yield
        return
    g = torch.Generator(device="cpu")
    g.set_state(state[0])
    with dropout_generator(g, state[1]):
        yield


def next_seed_words() -> Tuple[int, int]:
    """Seed words for one dropout call, from the innermost
    :func:`dropout_generator`; raises outside of one."""
    top = _top()
    g: Optional[torch.Generator] = top[0] if top is not None else None
    if g is None:
        raise RuntimeError(
            "dropout in training mode needs a generator: pass generator= "
            "to the model's forward, run it under TrainStep, or call "
            "model.eval()")
    return seed_words(g)
