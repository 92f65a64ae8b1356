"""The tensor-parallel RNG tracker, on explicit generators.

Counterpart of ``paddle_tpu/distributed/meta_parallel/parallel_layers/
random.py``: named streams, a ``global_seed`` one that every rank draws
alike and a ``local_seed`` one that differs across the mp ranks
(``model_parallel_random_seed``: ``seed`` and ``seed + 1024 +
mp_rank``, ``:55-65``). Each stream is a CPU ``torch.Generator``;
:meth:`RNGStatesTracker.rng_state` makes the dropouts inside it draw
their seed words from that stream (``core.random.dropout_generator``,
keeping the active batch base).

The port's models do not need the tracker for tensor parallelism: their
dropout masks hash absolute batch, head and element coordinates, so
every rank draws its slice of the single-process masks from the shared
step generator.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ....core import random as _random

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG",
           "GLOBAL_RNG"]

MODEL_PARALLEL_RNG = "local_seed"
GLOBAL_RNG = "global_seed"


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}

    def add(self, name: str, seed: int) -> None:
        if name in self.states_:
            raise ValueError(f"state {name!r} already exists")
        self.states_[name] = _random.make_generator(int(seed), "cpu")

    def get_states_tracker(self) -> Dict[str, torch.Tensor]:
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states) -> None:
        for name, st in states.items():
            g = self.states_.get(name) or torch.Generator(device="cpu")
            g.set_state(st)
            self.states_[name] = g

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """Dropouts in the block draw their seed words from stream
        ``name``."""
        if name not in self.states_:
            raise ValueError(f"state {name!r} does not exist")
        with _random.dropout_generator(self.states_[name],
                                       _random.dropout_batch_base()):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 0) -> None:
    """Fresh ``global_seed`` (``seed``) and ``local_seed`` (``seed +
    1024 + mp_rank``) streams, and torch's global seed."""
    from ...fleet import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    global _tracker
    _tracker = RNGStatesTracker()
    _tracker.add(GLOBAL_RNG, seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
    torch.manual_seed(seed)
