"""Model compression: post-training quantization and QAT.

Counterpart of ``paddle_tpu/slim/__init__.py``. Quantization rewrites the
layer tree in place: :class:`QuantizedLinear` replaces the port's
``nn.layers.Linear``.

- :func:`quantize_weights` (and ``inference.Config.enable_int8``):
  per-output-channel int8 weights that stay int8 through the product.
  The forward quantizes the activations per tensor (the dynamic absmax,
  or a calibrated ``act_scale``) and runs the int8 kernel
  (``ops.kernels.quant_matmul``) whenever K and N are multiples of 128,
  as the JAX package routes on the TPU. Other shapes take the JAX
  package's own compositions (weight-only: dequantize into a float
  matmul; static activations: the int8 product, here in float64, which
  is exact), and each such call is counted as
  ``kernels.FALLBACKS[("int8_matmul", "shape")]``.
- :class:`PostTrainingQuantization`: calibration batches record each
  eligible Linear's input absmax; ``run()`` bakes ``act_scale = absmax /
  127`` into the replacements.
- :class:`QAT`: fake quant with straight-through gradients around
  weights and activations; ``convert`` strips it to the deploy form.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers.common import Linear
from ..nn.quant import PerChannelAbsMaxObserver
from ..ops.kernels import note_fallback
from ..ops.kernels.quant_matmul import int8_linear, matmul_shapes_supported

__all__ = ["QuantizedLinear", "quantize_weights",
           "PostTrainingQuantization", "QAT", "fake_quant"]


def _channel_scales(w: np.ndarray, bits: int = 8) -> np.ndarray:
    """Per-output-channel scales of a ``[in, out]`` weight, by the one
    observer rule."""
    return PerChannelAbsMaxObserver(quant_bits=bits, quant_axis=1).observe(w)


class QuantizedLinear(nn.Module):
    """Linear with int8 weights: ``weight_q [in, out]`` int8 and ``scale
    [out]`` float32 buffers and the ``bias`` parameter (the JAX state
    dict's keys). ``weight_q`` is the transposed view of ``[out, in]``
    storage: the K-major layout the int8 kernel reads (its ``wgmma``
    takes 8-bit operands only so), held once, with the JAX layer's
    shape and values. ``act_scale`` is the calibrated static activation
    scale (a float) or None (dynamic per-tensor); a static scale is also
    held on the device as the non-persistent one-element buffer
    ``act_scale_tensor``, which the kernel reads by pointer."""

    def __init__(self, weight_q, scale, bias=None,
                 act_scale: Optional[float] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        k_major = np.ascontiguousarray(np.asarray(weight_q, np.int8).T)
        self.register_buffer("weight_q", torch.as_tensor(
            k_major, device=device).t())
        self.register_buffer("scale", torch.as_tensor(
            np.asarray(scale, np.float32), device=device))
        self.bias = None
        if bias is not None:
            self.bias = nn.Parameter(torch.as_tensor(bias).detach().clone()
                                     .to(device=device, dtype=torch.float32))
        self.act_scale = act_scale
        if act_scale is not None:
            self.register_buffer(
                "act_scale_tensor",
                torch.tensor([act_scale], dtype=torch.float32, device=device),
                persistent=False)

    @classmethod
    def from_linear(cls, lin: Linear, act_scale: Optional[float] = None):
        """Quantize ``lin`` in numpy as the JAX package does: scales by
        the observer rule, ``np.round`` (half to even), clip to +-127."""
        w = lin.weight.detach().float().cpu().numpy()
        scale = _channel_scales(w)
        q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
        return cls(q, scale, lin.bias, act_scale=act_scale,
                   device=lin.weight.device)

    def forward(self, x):
        K, N = self.weight_q.shape
        if matmul_shapes_supported(K, N):
            return int8_linear(
                x, self.weight_q, self.scale, self.bias,
                None if self.act_scale is None else self.act_scale_tensor)
        note_fallback("int8_matmul", "shape")
        if self.act_scale is None:
            # weight-only: dequantize into the float matmul
            w = self.weight_q.to(x.dtype) * self.scale.to(x.dtype)
            y = x @ w
        else:
            # static activations: the int8 product (exact in float64)
            xq = torch.round(x.float() / self.act_scale_tensor[0]) \
                .clamp_(-127, 127)
            y = (xq.double() @ self.weight_q.double()).float() \
                * (self.act_scale_tensor[0] * self.scale)
            y = y.to(x.dtype)
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        mode = "int8-act" if self.act_scale is not None else "weight-only"
        return f"in={self.weight_q.shape[0]}, out={self.weight_q.shape[1]}" \
               f", {mode}"


def _replace_linears(model: nn.Module, make, min_params: int) -> int:
    """Swap every eligible ``Linear`` child (exactly that type) for
    ``make(linear, qualified_name)``, unless it returns None."""
    count = 0
    for name, sub in list(model.named_modules()):
        for child_name, child in list(sub.named_children()):
            if type(child) is Linear and child.weight.numel() >= min_params:
                replacement = make(child, f"{name}.{child_name}".strip("."))
                if replacement is not None:
                    setattr(sub, child_name, replacement)
                    count += 1
    return count


def quantize_weights(model: nn.Module, min_params: int = 4096) -> int:
    """Weight int8 quantization in place (channel-wise absmax); returns
    the number of layers quantized."""
    return _replace_linears(
        model, lambda lin, _: QuantizedLinear.from_linear(lin), min_params)


class PostTrainingQuantization:
    """Static (activation) PTQ with absmax calibration::

        ptq = PostTrainingQuantization(model)
        for batch in calibration: ptq.collect(*batch)
        qmodel = ptq.run()
    """

    def __init__(self, model: nn.Module, min_params: int = 4096):
        self.model = model
        self.min_params = min_params
        self._ranges: Dict[int, torch.Tensor] = {}
        self._hooks = [
            sub.register_forward_pre_hook(self._observe(id(sub)))
            for sub in model.modules()
            if type(sub) is Linear and sub.weight.numel() >= min_params]

    def _observe(self, key):
        def hook(layer, inputs):
            m = inputs[0].detach().abs().amax().float()
            prev = self._ranges.get(key)
            self._ranges[key] = m if prev is None else torch.maximum(prev, m)
        return hook

    def collect(self, *batch):
        """One calibration forward."""
        with torch.no_grad():
            self.model(*batch)

    def ranges(self) -> Dict[int, float]:
        """The recorded absmax of each observed Linear, by ``id``."""
        return {k: float(v) for k, v in self._ranges.items()}

    def run(self) -> nn.Module:
        for h in self._hooks:
            h.remove()
        ranges = self.ranges()

        def make(lin, _):
            m = ranges.get(id(lin))
            if m is None or m == 0.0:
                return None                      # never observed: keep f32
            return QuantizedLinear.from_linear(lin, act_scale=m / 127.0)

        _replace_linears(self.model, make, self.min_params)
        return self.model


def fake_quant(x, bits: int = 8):
    """Per-tensor quantize-dequantize with a straight-through gradient."""
    qmax = 2.0 ** (bits - 1) - 1
    s = torch.clamp_min(x.abs().amax() / qmax, 1e-8)
    q = torch.round(x / s).clamp(-qmax, qmax) * s
    return x + (q - x).detach()


class _QATLinear(nn.Module):
    """A Linear trained under fake-quantized weights and activations."""

    def __init__(self, lin: Linear, bits: int = 8):
        super().__init__()
        self.inner = lin
        self.bits = bits

    def forward(self, x):
        return F.linear(fake_quant(x, self.bits),
                        fake_quant(self.inner.weight, self.bits),
                        self.inner.bias)


class QAT:
    """Quantization-aware training: ``quantize`` wraps eligible Linears
    in fake quant, ``convert`` emits the int8 deploy model."""

    def __init__(self, bits: int = 8, min_params: int = 4096):
        self.bits = bits
        self.min_params = min_params

    def quantize(self, model: nn.Module) -> nn.Module:
        _replace_linears(model, lambda lin, _: _QATLinear(lin, self.bits),
                         self.min_params)
        return model

    def convert(self, model: nn.Module) -> nn.Module:
        """Strip the fake-quant wrappers to ``QuantizedLinear``."""
        for _, sub in list(model.named_modules()):
            for child_name, child in list(sub.named_children()):
                if isinstance(child, _QATLinear):
                    setattr(sub, child_name,
                            QuantizedLinear.from_linear(child.inner))
        return model
