"""Activation layers (counterpart of ``paddle_tpu/nn/layers/activation.py``):
the ones the vision models and the JAX vision tests use."""

from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh"]


class _Act(nn.Module):
    _fn = None

    def forward(self, x):
        return type(self)._fn(x)


class ReLU(_Act):
    _fn = staticmethod(F.relu)


class ReLU6(_Act):
    _fn = staticmethod(F.relu6)


class Sigmoid(_Act):
    _fn = staticmethod(F.sigmoid)


class Tanh(_Act):
    _fn = staticmethod(F.tanh)
