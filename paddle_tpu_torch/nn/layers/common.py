"""Common layers: counterpart of ``paddle_tpu/nn/layers/common.py``.

Parameters are built as zeros on the given device; ``reset_parameters``
draws them from a ``torch.Generator`` by the JAX layer's default
initializer, so a model initialises its layers in one pass from one
seed. The JAX package's names and layouts are kept (``Linear.weight`` is
``[in, out]``), so weights copy across by name.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import functional as F
from ..initializer import make_param, reinit
from ..layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Flatten", "Identity"]


class Linear(Layer):
    """``y = x W + b`` with ``W [in, out]`` (``common.py:21-36``);
    ``weight_attr`` / ``bias_attr`` as in JAX (``nn.initializer``):
    ``False`` builds no bias, an initializer or ``ParamAttr`` replaces
    the default one (and ``trainable=False`` freezes the parameter)."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None, bias_attr=None,
                 weight_attr=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = make_param((in_features, out_features), weight_attr,
                                 device)
        self.bias = make_param((out_features,), bias_attr, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """XavierUniform weight (the JAX default), zero bias, unless an
        attr gave the parameter its own initializer."""
        limit = math.sqrt(6.0 / (self.in_features + self.out_features))
        reinit(self.weight, generator,
               lambda p, g: p.uniform_(-limit, limit, generator=g))
        reinit(self.bias, generator, lambda p, g: p.zero_())

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Token embedding (``common.py:93-112``): rows of ``weight`` at the
    ids; ``weight_attr`` as :class:`Linear`'s."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device: Optional[torch.device] = None, weight_attr=None):
        super().__init__()
        self.weight = make_param((num_embeddings, embedding_dim),
                                 weight_attr, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         std: float = 1.0) -> None:
        """N(0, std); the JAX default is N(0, 1)."""
        reinit(self.weight, generator,
               lambda p, g: p.normal_(0.0, std, generator=g))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(Layer):
    """``upscale_in_train`` dropout, active in training mode."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def seed_draws(self) -> int:
        """Seed-word pairs a call draws (``core.random.count_seed_draws``)."""
        return int(self.training and 0.0 < self.p < 1.0)

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)


class Identity(Layer):
    """Returns its input (``inference.passes.fold_conv_bn`` puts one where
    a folded BatchNorm was)."""

    def forward(self, x):
        return x


class Flatten(Layer):
    """Merge dims ``start_axis .. stop_axis`` (``common.py``'s Flatten)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)
