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
only. A pipeline stage positions its layers' draws in the
single-process call order: :func:`count_seed_draws` counts a module's
draws a call, :func:`advance_dropout_state` moves a saved state past
some draws, and :func:`skip_seed_words` moves the active generator.

A sequence-parallel rank holds positions ``s0 .. s0 + S/sp - 1`` of
each row of a ``[B, S, ...]`` stream; inside :func:`sequence_shard`
(which keeps the active generator and batch base) the dropouts hash
those positions' absolute index (:func:`dropout_sequence_shard`), so
the rank draws its shard of the single-process masks too.

The eager API's stateful side (``paddle_tpu/core/random.py:57``):
:func:`seed` reseeds the generators of ``tensor.random`` (one a device,
made on first use) and installs a process-wide dropout generator,
``torch.Generator("cpu").manual_seed(s)`` as ``TrainStep(seed=s)``
makes its own, at the bottom of the :func:`dropout_generator` stack.
An eager training loop after ``paddle.seed(s)`` thus draws the seed
words that ``TrainStep(seed=s)`` draws over the same steps. Before any
:func:`seed`, dropout in training mode outside a generator still
raises.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

from .device import DeviceLike, resolve_device

__all__ = ["make_generator", "seed_words", "dropout_generator", "seed",
           "random_generator", "get_rng_state", "set_rng_state",
           "next_seed_words", "dropout_batch_base", "dropout_state",
           "replay_dropout_state", "count_seed_draws",
           "advance_dropout_state", "skip_seed_words", "sequence_shard",
           "dropout_sequence_shard"]

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
    with _pushed((generator, int(batch_base), None)):
        yield


@contextlib.contextmanager
def _pushed(entry) -> Iterator[None]:
    stack = _SCOPE.__dict__.setdefault("stack", [])
    stack.append(entry)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def sequence_shard(start: int, total: int) -> Iterator[None]:
    """Dropout inside this block takes dim 1 of its tensors as positions
    ``start ..`` of a sequence of ``total`` (a sequence-parallel rank's
    shard), with the active generator and batch base; outside any
    :func:`dropout_generator` it does nothing."""
    top = _top()
    if top is None:
        yield
        return
    with _pushed((top[0], top[1], (int(start), int(total)))):
        yield


def dropout_sequence_shard():
    """``(start, total)`` of the active :func:`sequence_shard`, or
    None."""
    top = _top()
    return top[2] if top is not None else None


def _top():
    stack = _SCOPE.__dict__.get("stack")
    if stack:
        return stack[-1]
    return _EAGER["dropout"]


# the eager API's generators (:func:`seed`): the process-wide dropout
# entry under every dropout_generator scope, and the random functions'
# generator of each device
_EAGER = {"seed": 0, "dropout": None, "random": {}}


def seed(value: int) -> int:
    """``paddle.seed``: the random functions' generators restart from
    ``value`` and the process-wide dropout generator is a CPU generator
    seeded with ``value``. Returns ``value``."""
    value = int(value)
    g = torch.Generator(device="cpu")
    g.manual_seed(value)
    _EAGER["seed"] = value
    _EAGER["dropout"] = (g, 0, None)
    _EAGER["random"] = {}
    return value


def random_generator(device) -> torch.Generator:
    """The random functions' generator on ``device``, seeded from the
    last :func:`seed` (0 before one) at its first use."""
    dev = torch.device(device)
    key = (dev.type, dev.index or 0) if dev.type == "cuda" else ("cpu", 0)
    g = _EAGER["random"].get(key)
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_EAGER["seed"])
        _EAGER["random"][key] = g
    return g


def get_rng_state():
    """The seed and every generator's state (what :func:`set_rng_state`
    takes back)."""
    drop = _EAGER["dropout"]
    return {"seed": _EAGER["seed"],
            "dropout": None if drop is None else drop[0].get_state(),
            "random": {k: g.get_state()
                       for k, g in _EAGER["random"].items()}}


def set_rng_state(state) -> None:
    _EAGER["seed"] = int(state["seed"])
    if state["dropout"] is None:
        _EAGER["dropout"] = None
    else:
        g = torch.Generator(device="cpu")
        g.set_state(state["dropout"])
        _EAGER["dropout"] = (g, 0, None)
    gens = {}
    for key, st in state["random"].items():
        g = torch.Generator(device=torch.device(
            key[0], key[1]) if key[0] == "cuda" else "cpu")
        g.set_state(st)
        gens[key] = g
    _EAGER["random"] = gens


def dropout_batch_base() -> int:
    """The global index of the first batch row of the tensors the active
    :func:`dropout_generator` drops (0 outside of one)."""
    top = _top()
    return top[1] if top is not None else 0


def dropout_state():
    """The active generator's state, batch base and sequence shard, or
    None outside a :func:`dropout_generator` (what
    :func:`replay_dropout_state` takes)."""
    top = _top()
    if top is None:
        return None
    return top[0].get_state(), top[1], top[2]


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
    with _pushed((g, state[1], state[2] if len(state) > 2 else None)):
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


def count_seed_draws(module) -> int:
    """The seed-word pairs one call of ``module`` draws in its current
    mode: the sum of ``seed_draws()`` over its submodules that define it
    (every dropout site of the port does)."""
    return sum(int(m.seed_draws()) for m in module.modules()
               if hasattr(m, "seed_draws"))


def advance_dropout_state(state, n: int):
    """:func:`dropout_state`'s tuple after ``n`` more draws of seed
    words (None stays None)."""
    if state is None or n == 0:
        return state
    g = torch.Generator(device="cpu")
    g.set_state(state[0])
    for _ in range(n):
        seed_words(g)
    return (g.get_state(),) + tuple(state[1:])


def skip_seed_words(n: int) -> None:
    """Draw ``n`` pairs of seed words from the active generator and drop
    them (nothing outside a :func:`dropout_generator`)."""
    top = _top()
    if top is None:
        return
    for _ in range(n):
        seed_words(top[0])
