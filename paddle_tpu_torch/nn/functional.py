"""The functional ops the port's models need, with the JAX package's
precision semantics.

Counterpart of ``paddle_tpu/nn/functional.py``: ``linear`` (:func:`linear`,
Paddle's ``[in, out]`` weight, with the ``FLAGS_amp_int8_matmul`` route
of :222-266), ``embedding``, ``gelu``, ``tanh``,
``layer_norm`` (:1014), ``dropout`` (:1115), the dense
hard-label ``cross_entropy`` (:1222), ``binary_cross_entropy_with_logits``
(:1342) and ``scaled_dot_product_attention`` (:1808, over
``ops/attention.py``), and the vision ops of ``functional_vision``
(convolutions, pools, ``batch_norm``, ``fused_conv_bn``, ``relu``,
``relu6``, ``sigmoid``, ``flatten``). Each casts its inputs under AMP by
the JAX op name (``amp.cast_inputs``).

- ``layer_norm`` computes in float32 and returns its input's dtype, as
  the JAX op does (``torch.nn.LayerNorm`` does not take bf16 input with
  f32 weights on the CPU, and under ``torch.autocast`` returns f32).
- ``cross_entropy`` is the dense branch only (softmax over the last
  axis in float32, hard labels of shape ``[B]`` or ``[B, 1]``,
  ``ignore_index``, ``reduction``): the models call it for the 2-class
  SOP head and the vision classifiers (10 and 1000 classes, under the
  chunked path's 4096 threshold); the vocab-wide losses go through
  ``nn.chunked_ce``.
- ``dropout`` with ``axis=None`` and ``upscale_in_train`` goes through
  the fused dropout kernel on the card whatever the tensor's size: the
  JAX package's ``a.size >= 65536`` gate (:1131) was a TPU launch-cost
  heuristic, and the keep bits are the same function of the element
  index either way. Its seed words come from the active
  ``core.random.dropout_generator``; inside one entered with a batch
  base (a data-parallel rank's rows), x is taken as batch-major and
  hashes from element ``batch_base * (x.numel() / x.shape[0])``, so the
  rank draws its rows of the whole batch's mask. Inside a
  ``core.random.sequence_shard`` (a sequence-parallel rank's ``[B,
  S/sp, ...]`` shard of a ``[B, S, ...]`` stream) its elements hash
  their index in the whole stream: rows of ``S/sp`` positions, ``S``
  positions apart (the kernel's row stride).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp import cast_inputs, is_active
from ..core.flags import get_flag
from ..core.random import (dropout_batch_base, dropout_sequence_shard,
                           next_seed_words)
from ..core.tensor import paddle_api
from ..ops import attention as _attention
from . import functional_vision as _vision
from .functional_vision import *  # noqa: F401,F403
from ..ops.kernels import note_fallback
from ..ops.kernels.dropout import fused_dropout
from ..ops.kernels.quant_matmul import (int8_amp_linear,
                                        matmul_shapes_supported)

__all__ = ["linear", "embedding", "gelu", "tanh", "layer_norm",
           "dropout", "cross_entropy", "binary_cross_entropy_with_logits",
           "scaled_dot_product_attention"] + _vision.__all__


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


class _Embedding(torch.autograd.Function):
    """``F.embedding`` with a deterministic gradient. On the card
    PyTorch's float32 embedding backward accumulates duplicate ids with
    atomics, so a row that many ids share (a token-type or position
    table) gets other bits run to run, and a resumed run could not
    repeat an uninterrupted one. The backward here is the same
    ``embedding_dense_backward`` under PyTorch's deterministic mode (its
    sort-based reduction, the same sums to the last bits the atomics
    give at best), switched on for this call only."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        on = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            gw = torch.ops.aten.embedding_dense_backward(
                g.contiguous(), ids, ctx.rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(on, warn_only=warn)
        return None, gw


def embedding(ids, weight):
    """Rows of ``weight`` at ``ids`` (weight cast under AMP first), with
    a deterministic gradient (:class:`_Embedding`)."""
    (weight,) = cast_inputs("embedding", weight)
    return _Embedding.apply(ids, weight)


def gelu(x, approximate: bool = False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Float32 statistics and affine, output in ``x``'s dtype. On the
    card, with weight and bias in ``x``'s dtype (a bf16 serving
    engine's parameter copy), PyTorch's kernel does just that in one
    launch, where the casts below would add four."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if x.is_cuda and all(t is None or t.dtype == x.dtype
                         for t in (weight, bias)):
        return F.layer_norm(x, tuple(normalized_shape), weight, bias,
                            epsilon)
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
    # rows b0.. of a larger batch hash from their first element's index
    b0 = dropout_batch_base()
    shard = dropout_sequence_shard()
    if shard is not None:
        # positions s0.. of each row of a stream of S positions
        s0, S = shard
        inner = x.numel() // (x.shape[0] * x.shape[1])
        row_len, row_stride = x.shape[1] * inner, S * inner
        return fused_dropout(x, p, next_seed_words(),
                             b0 * row_stride + s0 * inner, row_len,
                             row_stride)
    base = b0 * (x.numel() // x.shape[0]) if b0 else 0
    return fused_dropout(x, p, next_seed_words(), base)


def cross_entropy(input, label, ignore_index: int = -100,
                  reduction: str = "mean"):
    """Softmax cross-entropy over the last axis with hard labels
    (``label`` of ``input``'s leading shape, or with a trailing 1),
    skipping ``ignore_index``; float32 math, as the O1 black list casts
    ``cross_entropy``. ``reduction``: ``"mean"`` over the labels that
    count, ``"sum"`` or ``"none"``."""
    (input,) = cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input.float(), dim=-1)
    ids = label.long()
    if ids.dim() == logp.dim():
        ids = ids.squeeze(-1)
    valid = (ids != ignore_index).float()
    safe = torch.where(ids == ignore_index, 0, ids)
    loss = -logp.gather(-1, safe[..., None])[..., 0] * valid
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1e-12)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r}: expected 'mean', 'sum' or "
                     "'none'")


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r}: expected 'mean', 'sum' or "
                     "'none'")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None):
    """Sigmoid cross-entropy on logits in float32, in the JAX op's
    ``log_sigmoid`` form (``functional.py:1342-1367``): ``-(pw * y *
    log_sigmoid(z) + (1 - y) * log_sigmoid(-z))``, times ``weight``,
    then ``reduction`` (``"mean"``, ``"sum"`` or ``"none"``)."""
    z = logit.float()
    y = label.float()
    pos = y * F.logsigmoid(z)
    if pos_weight is not None:
        pos = pos_weight * pos
    loss = -(pos + (1 - y) * F.logsigmoid(-z))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 head_base: int = 0):
    """``paddle.nn.functional.scaled_dot_product_attention`` over ``[B, S,
    H, D]`` (``functional.py:1808``): on the card the flash kernels,
    causal or not, with the in-kernel dropout (rows 1 and 3) or a float
    ``[B, 1, 1, Sk]`` mask (rows 2, 4 and 5); its dropout draws seed
    words from the active dropout generator (``paddle.seed``'s outside
    one). ``head_base`` is the global index of the first head (a
    tensor-parallel rank's)."""
    return _attention.scaled_dot_product_attention(
        query, key, value, attn_mask, dropout_p, is_causal, training,
        head_base)


for _name in __all__:
    globals()[_name] = paddle_api(globals()[_name])
del _name
