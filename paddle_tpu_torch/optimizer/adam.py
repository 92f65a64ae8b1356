"""Adam and AdamW with the JAX package's formula.

Counterpart of ``paddle_tpu/optimizer/adam.py`` (:38-76), in float32:

    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g**2
    lr_t = lr * sqrt(1 - beta2**t) / (1 - beta1**t)
    p = p - lr_t * m / (sqrt(v) + eps)
    p = p - lr * weight_decay * p_old          (AdamW, every parameter)

``torch.optim.AdamW`` puts epsilon inside the bias correction and
applies the decay before the step, so it does not match this.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _init_slot(self, param):
        return (torch.zeros_like(param, dtype=torch.float32),
                torch.zeros_like(param, dtype=torch.float32))

    def _adam(self, param, grad, slots, lr, t) -> torch.Tensor:
        """Update the slots in place; return the new parameter (f32)."""
        m, v = slots
        g = grad.float()
        m.mul_(self.beta1).add_(g * (1 - self.beta1))
        v.mul_(self.beta2).add_(torch.square(g) * (1 - self.beta2))
        # the scalar chain in float32 on the host, in the JAX order
        f32 = torch.float32
        t_f = torch.tensor(float(t), dtype=f32)
        bc1 = 1 - torch.pow(torch.tensor(self.beta1, dtype=f32), t_f)
        bc2 = 1 - torch.pow(torch.tensor(self.beta2, dtype=f32), t_f)
        lr_t = float(torch.tensor(lr, dtype=f32) * torch.sqrt(bc2) / bc1)
        return param.float() - lr_t * m / (torch.sqrt(v) + self.epsilon)

    def _update(self, param, grad, slots, lr, t):
        param.copy_(self._adam(param, grad, slots, lr, t))


class AdamW(Adam):
    """Decoupled weight decay, applied to every parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd_coeff = float(weight_decay)

    def _update(self, param, grad, slots, lr, t):
        new = self._adam(param, grad, slots, lr, t)
        if self._wd_coeff:
            lr_wd = float(torch.tensor(lr, dtype=torch.float32)
                          * self._wd_coeff)
            new -= lr_wd * param.float()
        param.copy_(new)
