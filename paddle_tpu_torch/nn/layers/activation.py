"""Activation layers (counterpart of ``paddle_tpu/nn/layers/activation.py``):
the ones the vision models and the JAX vision tests use."""

from __future__ import annotations

from .. import functional as F
from ..layer import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh"]


class _Act(Layer):
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
