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
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "Flatten", "Identity"]


def _zeros(*shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class Linear(nn.Module):
    """``y = x W + b`` with ``W [in, out]`` (``common.py:21-36``);
    ``bias_attr=False`` builds it without the bias (other ``bias_attr``
    objects wait for ``nn/initializer.py``)."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None, bias_attr=None):
        super().__init__()
        if bias_attr not in (None, False):
            raise NotImplementedError(
                "bias_attr objects wait for nn/initializer.py; pass None "
                "or False")
        self.in_features, self.out_features = in_features, out_features
        self.weight = _zeros(in_features, out_features, device=device)
        self.bias = None if bias_attr is False else _zeros(out_features,
                                                           device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """XavierUniform weight (the JAX default), zero bias."""
        limit = math.sqrt(6.0 / (self.in_features + self.out_features))
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Token embedding (``common.py:93-112``): rows of ``weight`` at the
    ids."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.weight = _zeros(num_embeddings, embedding_dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         std: float = 1.0) -> None:
        """N(0, std); the JAX default is N(0, 1)."""
        self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout, active in training mode."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def seed_draws(self) -> int:
        """Seed-word pairs a call draws (``core.random.count_seed_draws``)."""
        return int(self.training and 0.0 < self.p < 1.0)

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)


class Identity(nn.Module):
    """Returns its input (``inference.passes.fold_conv_bn`` puts one where
    a folded BatchNorm was)."""

    def forward(self, x):
        return x


class Flatten(nn.Module):
    """Merge dims ``start_axis .. stop_axis`` (``common.py``'s Flatten)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)
