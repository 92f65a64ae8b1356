"""Normalisation layers: counterpart of ``paddle_tpu/nn/layers/norm.py``.

``BatchNorm``, ``BatchNorm1D/2D/3D`` (``norm.py:20-64``): parameters
``weight`` (ones) and ``bias`` (zeros), buffers ``_mean`` (zeros) and
``_variance`` (ones), the JAX names, momentum 0.9 on the old value;
``nn.functional.batch_norm`` does the arithmetic. ``SyncBatchNorm`` is
not ported yet: ``jit.TrainStep`` refuses a BatchNorm model on a
data-parallel mesh."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm"]


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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise NotImplementedError(
                "weight_attr / bias_attr objects wait for nn/initializer.py;"
                " pass None (ones and zeros) or False (no parameter)")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.register_parameter("weight", None)
        else:
            self.weight = nn.Parameter(torch.ones(num_features,
                                                  device=device))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(num_features,
                                                 device=device))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCL" if data_format == "NCL" else "NLC",
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, device=device)
