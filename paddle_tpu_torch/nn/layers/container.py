"""Containers (counterpart of ``paddle_tpu/nn/layer.py::Sequential``,
:325): children named ``"0"``, ``"1"``, ... in order, or by the names an
``OrderedDict`` or ``(name, layer)`` pairs give, so state-dict keys are
the JAX model's (``features.0.weight``)."""

from __future__ import annotations

import collections

from torch import nn

__all__ = ["Sequential"]


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__(collections.OrderedDict(
            layer if isinstance(layer, tuple) else (str(i), layer)
            for i, layer in enumerate(layers)))
