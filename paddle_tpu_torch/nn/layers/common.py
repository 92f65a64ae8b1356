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

__all__ = ["Linear", "Embedding", "Dropout"]


def _zeros(*shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class Linear(nn.Module):
    """``y = x W + b`` with ``W [in, out]`` (``common.py:21-36``)."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _zeros(in_features, out_features, device=device)
        self.bias = _zeros(out_features, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """XavierUniform weight (the JAX default), zero bias."""
        limit = math.sqrt(6.0 / (self.in_features + self.out_features))
        self.weight.uniform_(-limit, limit, generator=generator)
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

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
