"""Convolution layers: counterpart of ``paddle_tpu/nn/layers/conv.py``.

The JAX package's layouts and names: ``weight [out, in/groups, *k]``
(``[in, out/groups, *k]`` for a transpose) and ``bias [out]``, both drawn
from Uniform(±1/sqrt(fan_in)) with ``fan_in = in * prod(k) / groups``
(``conv.py:49-58``) in :meth:`reset_parameters`; ``bias_attr=False``
leaves no ``bias`` parameter (and no state-dict key), an initializer or
``ParamAttr`` (``nn.initializer``) replaces the default one. The JAX
constructors' argument order is kept; ``padding_mode`` other than
``"zeros"`` raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import functional as F
from ..functional_vision import _ntuple
from ..initializer import make_param, reinit
from ..layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "fused_conv_bn_act"]


def _check_padding_mode(padding_mode) -> None:
    if padding_mode != "zeros":
        raise NotImplementedError(
            f"padding_mode={padding_mode!r}: only 'zeros' is ported")


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, transpose,
                 stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None, device: Optional[torch.device] = None):
        super().__init__()
        _check_padding_mode(padding_mode)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = _ntuple(stride, n)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _ntuple(dilation, n)
        self._groups = groups
        self._data_format = data_format
        if transpose:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        self.weight = make_param(shape, weight_attr, device)
        bias = make_param((out_channels,), bias_attr, device)
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = bias

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weight and bias from Uniform(±1/sqrt(fan_in)), the JAX layer's
        default initializer."""
        fan_in = self._in_channels * int(np.prod(self._kernel_size)) \
            // self._groups
        bound = 1.0 / math.sqrt(fan_in)

        def default(p, g):
            p.uniform_(-bound, bound, generator=g)
        reinit(self.weight, generator, default)
        reinit(self.bias, generator, default)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


def fused_conv_bn_act(conv, bn, x, activation=None):
    """A (Conv2D, BatchNorm2D) layer pair then relu / relu6
    (``conv.py:64-94``) as ``bn(conv(x))``, through the layers' own calls,
    so a BN folded to Identity by ``inference.passes.fold_conv_bn`` runs
    too. The JAX ``FLAGS_fused_conv_bn`` switch is not ported:
    ``nn.functional.fused_conv_bn`` is the same three PyTorch calls."""
    out = bn(conv(x))
    if activation == "relu":
        out = F.relu(out)
    elif activation == "relu6":
        out = F.relu6(out)
    return out


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _ConvTransposeNd(_ConvNd):
    _n = 0

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         True, stride, padding, output_padding, dilation,
                         groups, "zeros", weight_attr, bias_attr,
                         data_format, device)

    def forward(self, x, output_size=None):
        fn = getattr(F, f"conv{self._n}d_transpose")
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._output_padding, self._groups, self._dilation,
                  output_size, self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _n = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device)


class Conv2DTranspose(_ConvTransposeNd):
    _n = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device)


class Conv3DTranspose(_ConvTransposeNd):
    _n = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device)
