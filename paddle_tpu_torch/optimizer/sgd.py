"""Plain SGD with the JAX package's formula.

Counterpart of ``paddle_tpu/optimizer/sgd.py::SGD`` (``p = p - lr *
g`` in float32; a float ``weight_decay`` adds ``coeff * p`` to the
gradient first, the base class's coupled L2). ``Momentum`` comes with
``vision/``.
"""

from __future__ import annotations

from .optimizer import Optimizer

__all__ = ["SGD"]


class SGD(Optimizer):
    def _update(self, param, grad, slots, lr, t):
        param.copy_(param.float() - lr * grad.float())
