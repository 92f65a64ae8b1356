"""Pooling layers: counterpart of ``paddle_tpu/nn/layers/pooling.py``,
each a thin layer over its ``nn.functional`` op; ``MaxUnPool2D``
(``pooling.py:91``) takes the indices ``max_pool2d(return_mask=True)``
returns."""

from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool2D"]


class _Pool(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              **self.kwargs)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)


class _AdaptivePool(nn.Module):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)


class MaxUnPool2D(nn.Module):
    """Inverse of ``MaxPool2D`` given its pooled indices."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.output_size,
                              self.data_format)
