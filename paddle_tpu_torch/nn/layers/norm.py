"""Normalisation layers: counterpart of ``paddle_tpu/nn/layers/norm.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """``weight``/``bias`` over the last dim; float32 statistics, output
    in the input's dtype (``nn/functional.py:1014``)."""

    def __init__(self, size: int, device: Optional[torch.device] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self.eps)
