"""SGD and Momentum with the JAX package's formulas.

Counterpart of ``paddle_tpu/optimizer/sgd.py`` (:14-54), in float32:
``SGD`` is ``p = p - lr * g``; ``Momentum`` keeps a velocity ``v = m * v
+ g * rescale_grad`` and steps ``p = p - lr * v``, or with Nesterov ``p
= p - lr * (g + m * v)``. A float ``weight_decay`` adds ``coeff * p`` to
the gradient first (the base class's coupled L2).
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum"]


class SGD(Optimizer):
    def _update(self, param, grad, slots, lr, t):
        param.copy_(param.float() - lr * grad.float())


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 rescale_grad=1.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.momentum = momentum
        self.use_nesterov = use_nesterov
        self.rescale_grad = rescale_grad

    def _init_slot(self, param):
        return (torch.zeros(param.shape, dtype=torch.float32,
                            device=param.device),)

    def _update(self, param, grad, slots, lr, t):
        (vel,) = slots
        g = grad.float() * self.rescale_grad
        vel.copy_(self.momentum * vel + g)
        delta = g + self.momentum * vel if self.use_nesterov else vel
        param.copy_(param.float() - lr * delta)
