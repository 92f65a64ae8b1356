"""The functional ops GPT training needs, with the JAX package's
precision semantics.

Counterpart of ``paddle_tpu/nn/functional.py``: ``linear`` (:func:`linear`,
Paddle's ``[in, out]`` weight), ``embedding``, ``gelu``, ``layer_norm``
(:1014) and ``dropout`` (:1115). Each casts its inputs under AMP by the
JAX op name (``amp.cast_inputs``).

- ``layer_norm`` computes in float32 and returns its input's dtype, as
  the JAX op does (``torch.nn.LayerNorm`` does not take bf16 input with
  f32 weights on the CPU, and under ``torch.autocast`` returns f32).
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

from ..amp import cast_inputs
from ..core.random import next_seed_words
from ..ops.kernels.dropout import fused_dropout

__all__ = ["linear", "embedding", "gelu", "layer_norm", "dropout"]


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight [in, out]``."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = x @ weight
    return y if bias is None else y + bias


def embedding(ids, weight):
    """Rows of ``weight`` at ``ids`` (weight cast under AMP first)."""
    (weight,) = cast_inputs("embedding", weight)
    return F.embedding(ids, weight)


def gelu(x, approximate: bool = False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


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
