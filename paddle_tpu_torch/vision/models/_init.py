"""Weight initialisation shared by the vision models."""

from __future__ import annotations

import torch
from torch import nn

from ...core.random import make_generator


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, device: torch.device) -> None:
    """Draw every layer's parameters by its JAX default initializer, in
    module order, from one generator seeded with ``seed`` (BatchNorm's
    ones and zeros are set at construction)."""
    g = make_generator(seed, device)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
