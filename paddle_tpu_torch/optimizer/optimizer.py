"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``. Each optimizer
defines the JAX package's per-parameter rule, ``_init_slot(param) ->
slots`` and ``_update(param, grad, slots, lr, t)``, and the base class
applies it in place over every parameter that has a ``.grad``: PyTorch
keeps parameters as mutable tensors, so the update writes into them and
into the slots instead of returning new arrays (the JAX package's buffer
donation, by other means). ``lr`` reaches the rule as a Python float
that holds a float32 value exactly, and ``t`` (the 1-based step) as a
Python int: scalar arithmetic stays on the host, so a step makes no
host-to-device copies and no syncs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        self._lr = float(learning_rate)
        self._parameter_list: List[torch.nn.Parameter] = list(parameters)
        self._grad_clip = grad_clip
        # a float weight_decay is the coupled L2 decay g + coeff * p
        self._l2 = float(weight_decay or 0.0)
        self._accumulators: Dict[int, tuple] = {}   # id(param) -> slots
        self._step_count = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value: float) -> None:
        self._lr = float(value)

    # -- the rule (overridden) ----------------------------------------------
    def _init_slot(self, param: torch.Tensor) -> tuple:
        return ()

    def _update(self, param, grad, slots, lr, t) -> None:
        """Update ``param`` and ``slots`` in place."""
        raise NotImplementedError

    # -- state -------------------------------------------------------------
    def init_state(self) -> None:
        """Create every parameter's slots now rather than at its first
        update."""
        for p in self._parameter_list:
            self._slots(p)

    def _slots(self, p) -> tuple:
        slots = self._accumulators.get(id(p))
        if slots is None:
            slots = self._accumulators[id(p)] = self._init_slot(p)
        return slots

    @torch.no_grad()
    def step(self, step: Optional[int] = None) -> None:
        """Apply the rule to every parameter with a gradient. ``step`` is
        the 1-based step the bias corrections use; by default the
        optimizer counts its own."""
        live = [p for p in self._parameter_list if p.grad is not None]
        if not live:
            return
        self._step_count = self._step_count + 1 if step is None \
            else int(step)
        grads = {i: p.grad for i, p in enumerate(live)}
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        lr = float(torch.tensor(self.get_lr(), dtype=torch.float32))
        for i, p in enumerate(live):
            g = grads[i] + self._l2 * p if self._l2 else grads[i]
            self._update(p, g, self._slots(p), lr, self._step_count)

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Step count and every slot, as CPU tensors keyed
        ``param{i}_slot{j}`` (the JAX package's names)."""
        out: Dict[str, Any] = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            slots = self._accumulators.get(id(p))
            for j, s in enumerate(slots or ()):
                out[f"param{i}_slot{j}"] = s.detach().cpu().clone()
        return out

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        self._step_count = int(state.get("_step_count", 0))
        for i, p in enumerate(self._parameter_list):
            slots = self._slots(p)
            for j, s in enumerate(slots):
                key = f"param{i}_slot{j}"
                if key in state:
                    s.copy_(state[key])
