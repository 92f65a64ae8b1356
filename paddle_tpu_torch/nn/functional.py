"""The functional ops the port's models need, with the JAX package's
precision semantics.

Counterpart of ``paddle_tpu/nn/functional.py``: ``linear`` (:func:`linear`,
Paddle's ``[in, out]`` weight, with the ``FLAGS_amp_int8_matmul`` route
of :222-266), ``embedding``, ``gelu``, ``tanh``,
``layer_norm`` (:1014), ``dropout`` (:1115), the dense
hard-label ``cross_entropy`` (:1222) and ``scaled_dot_product_attention``
(``ops/attention.py``). Each casts its inputs under AMP by the JAX op
name (``amp.cast_inputs``).

- ``layer_norm`` computes in float32 and returns its input's dtype, as
  the JAX op does (``torch.nn.LayerNorm`` does not take bf16 input with
  f32 weights on the CPU, and under ``torch.autocast`` returns f32).
- ``cross_entropy`` is the dense branch only (softmax over the last
  axis in float32, hard labels, ``ignore_index``, mean): the models call
  it for the 2-class SOP head; their vocab-wide losses go through
  ``nn.chunked_ce``.
- ``dropout`` with ``axis=None`` and ``upscale_in_train`` goes through
  the fused dropout kernel on the card whatever the tensor's size: the
  JAX package's ``a.size >= 65536`` gate (:1131) was a TPU launch-cost
  heuristic, and the keep bits are the same function of the element
  index either way. Its seed words come from the active
  ``core.random.dropout_generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp import cast_inputs, is_active
from ..core.flags import get_flag
from ..core.random import next_seed_words
from ..ops.attention import scaled_dot_product_attention
from ..ops.kernels import note_fallback
from ..ops.kernels.dropout import fused_dropout
from ..ops.kernels.quant_matmul import (int8_amp_linear,
                                        matmul_shapes_supported)

__all__ = ["linear", "embedding", "gelu", "tanh", "layer_norm",
           "dropout", "cross_entropy", "scaled_dot_product_attention"]


def _amp_int8_active(weight) -> bool:
    """The ``FLAGS_amp_int8_matmul`` gate of :func:`linear`
    (``functional.py:222-245``): the flag set, an ``amp.auto_cast``
    region active, a 2-D weight whose K and N tile. A weight that does
    not tile is counted as the reference counts it."""
    if not get_flag("amp_int8_matmul") or not is_active() \
            or weight.dim() != 2:
        return False
    if not matmul_shapes_supported(*weight.shape):
        note_fallback("int8_matmul", "shape")
        return False
    return True


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight [in, out]``; under
    ``FLAGS_amp_int8_matmul`` and an active autocast region the product
    runs through the int8 kernel (``int8_amp_linear``)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    if _amp_int8_active(weight):
        return int8_amp_linear(x, weight, bias)
    y = x @ weight
    return y if bias is None else y + bias


def embedding(ids, weight):
    """Rows of ``weight`` at ``ids`` (weight cast under AMP first)."""
    (weight,) = cast_inputs("embedding", weight)
    return F.embedding(ids, weight)


def gelu(x, approximate: bool = False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Float32 statistics and affine, output in ``x``'s dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    w = weight.float() if weight is not None else None
    b = bias.float() if bias is not None else None
    return F.layer_norm(x.float(), tuple(normalized_shape), w, b,
                        epsilon).to(x.dtype)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train"):
    """``upscale_in_train`` dropout over the whole tensor."""
    if not training or p == 0.0:
        return x
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError(
            "only axis=None, mode='upscale_in_train' dropout is ported "
            "(the fused dropout kernel's case)")
    if p >= 1.0:
        return torch.zeros_like(x)
    return fused_dropout(x, p, next_seed_words())


def cross_entropy(input, label, ignore_index: int = -100):
    """Mean softmax cross-entropy over the last axis with hard labels
    (``label`` of ``input``'s leading shape, or with a trailing 1),
    skipping ``ignore_index``; float32 math, as the O1 black list casts
    ``cross_entropy``."""
    (input,) = cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input.float(), dim=-1)
    ids = label.long()
    if ids.dim() == logp.dim():
        ids = ids.squeeze(-1)
    valid = (ids != ignore_index).float()
    safe = torch.where(ids == ignore_index, 0, ids)
    loss = -logp.gather(-1, safe[..., None])[..., 0] * valid
    return loss.sum() / valid.sum().clamp(min=1e-12)
