"""Attention ops: the plain PyTorch composition and the flash-kernel
dispatch.

Counterpart of ``paddle_tpu/ops/attention.py``. Layout convention:
``[batch, seq, heads, head_dim]``.

Dispatch (``sdpa_array``): CPU tensors without dropout take
:func:`_sdpa_plain`. CUDA tensors with ``D in (64, 128)`` and no mask,
or a float mask that broadcasts to ``[B, 1, 1, Sk]`` (an additive key
bias: the padding mask of BERT and ERNIE), go through the hand-written
flash kernels (``FlashAttention``: forward, and the backward kernels as
its gradient; the biased ones return the mask's gradient too) at any
sequence length (the TPU gate's ``S % 128 == 0`` and ``S >= 256`` were
the TPU's tile shape; the CUDA kernels mask their own ragged edge), with
or without the in-kernel attention dropout. CPU calls with dropout take
the same ``FlashAttention``, whose plain versions apply the same hash
mask. Any other call (a boolean mask, another mask shape) raises
``NotImplementedError`` naming what is missing: nothing on the card
quietly runs the plain version.

:func:`scaled_dot_product_attention` is the layer-level entry: it casts
q, k, v and the mask under AMP as one op, as the JAX package's ``apply``
casts every floating input (``core/tensor.py:568-576``), and draws the
dropout seed words.
"""

from __future__ import annotations

import math

import torch

from ..amp import cast_inputs
from ..core.random import next_seed_words

__all__ = ["sdpa_array", "scaled_dot_product_attention",
           "attention_scores", "NEG_INF"]

NEG_INF = -1e30

#: head dims the flash kernel is built for
FLASH_HEAD_DIMS = (64, 128)


def attention_scores(q, k, mask=None, is_causal=False, scale=None):
    """Scaled, masked scores ``[B, H, Sq, Sk]`` in float32: the part of
    :func:`_sdpa_plain` before the softmax (its lse comes from here
    too)."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if is_causal:
        # bottom-right aligned, as tril(k=Sk-Sq) in the JAX composition
        causal = torch.ones((Sq, Sk), dtype=torch.bool,
                            device=q.device).tril(Sk - Sq)
        scores = scores.masked_fill(~causal, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, NEG_INF)
        else:
            scores = scores + mask
    return scores.float()


def _sdpa_plain(q, k, v, mask=None, is_causal=False, scale=None):
    """Reference composition, line for line with the JAX package's
    ``_sdpa_xla``: ``[B, S, H, D]`` in and out, float32 softmax."""
    scores = attention_scores(q, k, mask, is_causal, scale)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_gap(q, mask) -> str:
    """What the flash kernels lack for this call, or ``""``."""
    if mask is not None:
        if mask.dtype == torch.bool:
            return ("a boolean mask (the flash kernels take an additive "
                    "float key bias [B, 1, 1, Sk], as "
                    "ops/pallas/flash_attention.py::_fwd_v1 does)")
        if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
            return (f"a mask of shape {tuple(mask.shape)} (the flash "
                    "kernels take an additive key bias that broadcasts "
                    "to [B, 1, 1, Sk])")
    if q.device.type != "cpu" and q.shape[-1] not in FLASH_HEAD_DIMS:
        return (f"head_dim {q.shape[-1]} (the kernels take D in "
                f"{FLASH_HEAD_DIMS} on the card)")
    return ""


def sdpa_array(q, k, v, mask=None, dropout_p: float = 0.0,
               is_causal: bool = False, seed_words=None):
    """Scaled dot-product attention over ``[B, S, H, D]`` tensors;
    ``dropout_p > 0`` needs the two dropout ``seed_words``."""
    if q.device.type == "cpu" and dropout_p == 0.0:
        return _sdpa_plain(q, k, v, mask, is_causal)
    gap = _flash_gap(q, mask)
    if gap:
        raise NotImplementedError(f"no flash kernel for this attention "
                                  f"call: {gap}")
    # imported here: the kernel module's plain version is built on this
    # module's attention_scores
    from .kernels.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=is_causal, dropout_rate=dropout_p,
                           seed_words=seed_words, bias=mask)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """``F.scaled_dot_product_attention`` over ``[B, S, H, D]``: the AMP
    cast of all four inputs, the dropout only in training, with seed
    words from the active ``dropout_generator``."""
    p = dropout_p if training else 0.0
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    return sdpa_array(query, key, value, attn_mask, p, is_causal,
                      next_seed_words() if p > 0.0 else None)
