"""Attention ops: the plain PyTorch composition and the flash-kernel
dispatch.

Counterpart of ``paddle_tpu/ops/attention.py``. Layout convention:
``[batch, seq, heads, head_dim]``.

Dispatch (``sdpa_array``): CPU tensors without dropout take
:func:`_sdpa_plain`. CUDA tensors with no mask and ``D in (64, 128)``
go through the hand-written flash kernels (``FlashAttention``: forward,
and the backward kernel as its gradient) at any sequence length (the
TPU gate's ``S % 128 == 0`` and ``S >= 256`` were the TPU's tile shape;
the CUDA kernels mask their own ragged edge), with or without the
in-kernel attention dropout. CPU calls with dropout and no mask take the
same ``FlashAttention``, whose plain versions apply the same hash mask.
Any other call raises ``NotImplementedError`` naming the kernel that is
missing: nothing on the card quietly runs the plain version.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sdpa_array", "attention_scores", "NEG_INF"]

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


def sdpa_array(q, k, v, mask=None, dropout_p: float = 0.0,
               is_causal: bool = False, seed_words=None):
    """Scaled dot-product attention over ``[B, S, H, D]`` tensors;
    ``dropout_p > 0`` needs the two dropout ``seed_words``."""
    if q.device.type == "cpu" and dropout_p == 0.0:
        return _sdpa_plain(q, k, v, mask, is_causal)
    if mask is not None or (q.device.type != "cpu"
                            and q.shape[-1] not in FLASH_HEAD_DIMS):
        raise NotImplementedError(
            "no flash kernel for this attention call (mask="
            f"{mask is not None}, head_dim={q.shape[-1]}): the masked / "
            "biased flash forward (ops/pallas/flash_attention.py::_fwd_v1) "
            "is not ported yet and the ported one takes D in "
            f"{FLASH_HEAD_DIMS} on the card")
    # imported here: the kernel module's plain version is built on this
    # module's _sdpa_plain
    from .kernels.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=is_causal, dropout_rate=dropout_p,
                           seed_words=seed_words)
