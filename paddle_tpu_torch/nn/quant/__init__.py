"""nn.quant: fake-quantization layers for quantization-aware training.

Counterpart of ``paddle_tpu/nn/quant/__init__.py``: every fake quant is a
quantize-dequantize whose gradient is the identity (straight through,
``a + (q - a).detach()``); the moving-average ranges are float32
buffers updated in training mode and frozen in eval mode, as the JAX
layers update them on the eager tape and freeze them under jit.
:class:`PerChannelAbsMaxObserver` is the one per-channel scale rule of
the int8 stack, numpy on the host as in the JAX package: ``slim``'s
deploy pass and the kernel's ``quantize_per_channel`` follow it.

``QuantizedConv2D`` and ``QuantizedConv2DTranspose`` wrap the port's
``Conv2D`` / ``Conv2DTranspose``: a channel-wise fake-quantized weight
along its output axis (0 for a conv, 1 for a transpose's ``[in, out /
groups, kh, kw]``) and a moving-average fake-quantized input.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = [
    "FakeQuantAbsMax", "FakeQuantChannelWiseAbsMax",
    "FakeQuantMovingAverageAbsMax", "MovingAverageAbsMaxScale",
    "PerChannelAbsMaxObserver", "QuantizedLinear", "QuantizedConv2D",
    "QuantizedConv2DTranspose",
    "MAOutputScaleLayer", "FakeQuantMAOutputScaleLayer",
    "FloatFunctionalLayer", "add", "subtract", "multiply", "divide",
]


def _qmax(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1


def _qdq(a, scale, qmax):
    q = torch.round(a / scale).clamp(-qmax, qmax) * scale
    return a + (q - a).detach()           # straight-through gradient


class PerChannelAbsMaxObserver:
    """Per-channel symmetric-absmax weight observer (``:45-89``):
    ``observe(w)`` records and returns the scales ``absmax / (2^(bits-1)
    - 1)`` along ``quant_axis``, keeping the running absmax across calls;
    ``quantize(w)`` returns the int8 weights and scales on that grid."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = 1,
                 eps: float = 1e-8):
        self.quant_bits = int(quant_bits)
        self.quant_axis = int(quant_axis)
        self.eps = float(eps)
        self.scales = None

    @property
    def qmax(self) -> float:
        return _qmax(self.quant_bits)

    def observe(self, w) -> np.ndarray:
        w = np.asarray(w, np.float32)
        red = tuple(i for i in range(w.ndim) if i != self.quant_axis)
        absmax = np.abs(w).max(axis=red)
        if self.scales is not None:
            absmax = np.maximum(absmax, self.scales * self.qmax)
        self.scales = np.maximum(absmax / self.qmax, self.eps) \
            .astype(np.float32)
        return self.scales

    def quantize(self, w):
        w = np.asarray(w, np.float32)
        scales = self.scales if self.scales is not None else self.observe(w)
        shape = [1] * w.ndim
        shape[self.quant_axis] = -1
        q = np.clip(np.round(w / scales.reshape(shape)),
                    -self.qmax, self.qmax).astype(np.int8)
        return q, scales


class FakeQuantAbsMax(nn.Module):
    """Per-tensor absmax fake quant."""

    def __init__(self, name=None, quant_bits=8, dtype="float32"):
        super().__init__()
        self.quant_bits = quant_bits

    def forward(self, x):
        qmax = _qmax(self.quant_bits)
        s = torch.clamp_min(x.abs().amax() / qmax, 1e-9)
        return _qdq(x, s, qmax)


class FakeQuantChannelWiseAbsMax(nn.Module):
    """Per-channel absmax fake quant along ``quant_axis``."""

    def __init__(self, name=None, channel_num=None, quant_bits=8,
                 quant_axis=0, dtype="float32"):
        super().__init__()
        self.quant_bits = quant_bits
        self.quant_axis = quant_axis

    def forward(self, x):
        qmax = _qmax(self.quant_bits)
        red = [i for i in range(x.dim()) if i != self.quant_axis]
        s = torch.clamp_min(x.abs().amax(dim=red, keepdim=True) / qmax, 1e-9)
        return _qdq(x, s, qmax)


class FakeQuantMovingAverageAbsMax(nn.Module):
    """Moving-average absmax fake quant: the activation range is an EMA
    in the ``scale`` and ``state`` buffers, updated in training mode
    before the quantization uses it."""

    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32"):
        super().__init__()
        self.moving_rate = moving_rate
        self.quant_bits = quant_bits
        self.register_buffer("scale", torch.ones(()))
        self.register_buffer("state", torch.ones(()))

    @torch.no_grad()
    def update_range(self, x):
        """``state = state * rate + 1``, ``scale = (scale * rate *
        state_old + absmax) / state`` (in place; range tracking is state,
        not a gradient path)."""
        rate = self.moving_rate
        absmax = x.detach().abs().amax().to(self.scale.dtype)
        st2 = self.state * rate + 1.0
        self.scale.copy_((self.scale * rate * self.state + absmax) / st2)
        self.state.copy_(st2)

    def forward(self, x):
        qmax = _qmax(self.quant_bits)
        if self.training:
            self.update_range(x)
        s = torch.clamp_min(self.scale / qmax, 1e-9)
        return _qdq(x, s, qmax)


class MovingAverageAbsMaxScale(nn.Module):
    """Observe an EMA absmax in training mode without quantizing (the
    output scales a deploy pass records)."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32"):
        super().__init__()
        self._fq = FakeQuantMovingAverageAbsMax(moving_rate=moving_rate)

    @property
    def scale(self):
        return self._fq.scale

    def forward(self, x):
        if self.training:
            self._fq.update_range(x)
        return x


class QuantizedLinear(nn.Module):
    """QAT wrapper over the port's ``nn.layers.Linear``: fake-quantized
    weight (channel-wise along the output axis by default) and
    moving-average fake-quantized input."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max", **kw):
        super().__init__()
        self.inner = layer
        if weight_quantize_type == "channel_wise_abs_max":
            self._fq_w = FakeQuantChannelWiseAbsMax(quant_bits=weight_bits,
                                                    quant_axis=1)
        else:
            self._fq_w = FakeQuantAbsMax(quant_bits=weight_bits)
        self._fq_a = FakeQuantMovingAverageAbsMax(moving_rate=moving_rate,
                                                  quant_bits=activation_bits)

    def forward(self, x):
        from .. import functional as F
        return F.linear(self._fq_a(x), self._fq_w(self.inner.weight),
                        self.inner.bias)


class QuantizedConv2D(nn.Module):
    """QAT wrapper over the port's ``Conv2D``."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, **kw):
        super().__init__()
        self.inner = layer
        self._fq_w = FakeQuantChannelWiseAbsMax(quant_bits=weight_bits,
                                                quant_axis=0)
        self._fq_a = FakeQuantMovingAverageAbsMax(moving_rate=moving_rate,
                                                  quant_bits=activation_bits)

    def forward(self, x):
        from .. import functional as F
        inner = self.inner
        return F.conv2d(self._fq_a(x), self._fq_w(inner.weight), inner.bias,
                        stride=inner._stride, padding=inner._padding,
                        dilation=inner._dilation, groups=inner._groups,
                        data_format=inner._data_format)


class QuantizedConv2DTranspose(nn.Module):
    """QAT wrapper over the port's ``Conv2DTranspose``."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, **kw):
        super().__init__()
        self.inner = layer
        self._fq_w = FakeQuantChannelWiseAbsMax(quant_bits=weight_bits,
                                                quant_axis=1)
        self._fq_a = FakeQuantMovingAverageAbsMax(moving_rate=moving_rate,
                                                  quant_bits=activation_bits)

    def forward(self, x):
        from .. import functional as F
        inner = self.inner
        return F.conv2d_transpose(
            self._fq_a(x), self._fq_w(inner.weight), inner.bias,
            stride=inner._stride, padding=inner._padding,
            dilation=inner._dilation, groups=inner._groups,
            output_padding=getattr(inner, "_output_padding", 0),
            data_format=inner._data_format)


class MAOutputScaleLayer(nn.Module):
    """Wrap a layer and observe its output's EMA absmax."""

    def __init__(self, layer, moving_rate=0.9, name=None, dtype="float32"):
        super().__init__()
        self.inner = layer
        self._scale = MovingAverageAbsMaxScale(moving_rate=moving_rate)

    def forward(self, *args, **kwargs):
        return self._scale(self.inner(*args, **kwargs))


class FakeQuantMAOutputScaleLayer(nn.Module):
    """Wrap a layer, fake-quantizing its output with an EMA range."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, name=None, **kw):
        super().__init__()
        self.inner = layer
        self._fq = FakeQuantMovingAverageAbsMax(moving_rate=moving_rate,
                                                quant_bits=activation_bits)

    def forward(self, *args, **kwargs):
        return self._fq(self.inner(*args, **kwargs))


class FloatFunctionalLayer(nn.Module):
    """Elementwise ops as layers, so quantization passes can hook them."""


def _make_functional(opname, op):
    class _Op(FloatFunctionalLayer):
        def forward(self, x, y, name=None):
            return op(x, y)
    _Op.__name__ = _Op.__qualname__ = opname
    return _Op


add = _make_functional("add", torch.add)
subtract = _make_functional("subtract", torch.subtract)
multiply = _make_functional("multiply", torch.multiply)
divide = _make_functional("divide", torch.divide)
