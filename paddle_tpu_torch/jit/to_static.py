"""TrainStep: one eager training step over (model, loss, optimizer).

Counterpart of ``paddle_tpu/jit/to_static.py::TrainStep`` (:300) for one
device. The JAX class compiles the forward, backward and update into one
donated XLA program; here they run eagerly: ``loss_fn(layer, *batch)``,
``loss.backward()``, the optimizer's in-place update and
``clear_grad()``. A trainable parameter that the loss did not reach gets
a zero gradient before the update, as ``jax.value_and_grad`` over every
trainable parameter gives it (:607): AdamW then still decays it and
moves it by its momentum (BERT's pooler, an unused type embedding). The step count starts at 1, as at :1246-1248, and is
the ``t`` of the optimizer's bias corrections.

The step owns its dropout generator (a CPU ``torch.Generator`` seeded
from ``seed``): every dropout of the forward draws its seed words from
it, so a run repeats itself from the same seed and resumes exactly from
``state_dict()``, which holds the parameters, the optimizer's slots, the
step count and the generator's state.

Not ported: the mesh and its shardings, gradient accumulation, the
monitor hooks, and capturing the step in a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..core.random import dropout_generator

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, layer: torch.nn.Module, loss_fn: Callable,
                 optimizer, seed: int = 0):
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(seed))
        self.device = next(layer.parameters()).device
        self.step_count = 0
        optimizer.init_state()

    def _place(self, b) -> torch.Tensor:
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        return b.to(self.device)

    def __call__(self, *batch) -> torch.Tensor:
        """One step on ``batch``; returns the float32 loss on the device
        (reading it syncs)."""
        batch = [self._place(b) for b in batch]
        self.step_count += 1
        with dropout_generator(self.generator):
            loss = self.loss_fn(self.layer, *batch)
        loss.backward()
        for p in self.layer.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step(step=self.step_count)
        self.optimizer.clear_grad()
        return loss.detach().float()

    # -- checkpoint/resume -------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": {k: v.detach().cpu().clone()
                       for k, v in self.layer.state_dict().items()},
            "opt_state": self.optimizer.state_dict(),
            "step_count": self.step_count,
            "rng_state": self.generator.get_state(),
            "lr": self.optimizer.get_lr(),
        }

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        self.layer.load_state_dict(state["params"])
        self.optimizer.set_state_dict(state["opt_state"])
        self.optimizer.set_lr(state["lr"])
        self.step_count = int(state["step_count"])
        self.generator.set_state(state["rng_state"])
