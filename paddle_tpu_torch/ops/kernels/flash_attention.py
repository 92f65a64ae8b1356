"""Flash attention: wrappers of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``.

Replace the TPU kernels ``paddle_tpu/ops/pallas/flash_attention.py::
_fwd2`` (pallas_call at :399) and ``::_bwd2`` (pallas_call at :532).
The card bounds both by arithmetic; each source's header says what its
design does about it.

All functions take ``[B, S, H, D]`` tensors and an optional in-kernel
attention dropout (``dropout_rate`` with two ``seed_words``): the keep
bit is a hash of the absolute (b, h, query row, key column) and the
words (``ops/rng.py::attention_keep``, as ``_dropout_keep`` at :87); it
masks the p.V product only, the softmax denominator keeps the undropped
p, and the backward regenerates the same mask.

- :func:`flash_attention_fwd` -- ``o`` or ``(o, lse)``;
- :func:`flash_attention_bwd` -- ``(dq, dk, dv)`` from q, k, v, o, lse
  and dO; its plain version :func:`flash_attention_bwd_plain` reads the
  saved o and lse as the kernel does;
- :func:`flash_attention` -- the differentiable entry,
  ``FlashAttention`` (the ``_flash`` custom VJP at :866).

Given CPU tensors each wrapper computes its plain version; given CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..attention import NEG_INF, _sdpa_plain, attention_scores
from ..rng import attention_keep, keep_scale, keep_threshold, seed_mix
from . import FLASH_ATTENTION_BWD as _BWD
from . import FLASH_ATTENTION_FWD as _KERNEL
from . import check, function

__all__ = ["flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_plain", "flash_attention_bwd_plain",
           "flash_attention", "FlashAttention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SeedWords = Optional[Tuple[int, int]]


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None,
                          return_lse: bool = False,
                          dropout_rate: float = 0.0,
                          seed_words: SeedWords = None):
    """The kernel's function in plain PyTorch, computed in float32 and
    returned in q's dtype (plus ``lse [B, H, Sq]`` in float32)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    if dropout_rate > 0.0:
        scores = attention_scores(qf, kf, None, causal, scale)
        B, H, Sq, Sk = scores.shape
        keep = attention_keep(B, H, Sq, Sk, dropout_rate, seed_words,
                              device=q.device)
        probs = torch.softmax(scores, dim=-1) * torch.where(
            keep, keep_scale(dropout_rate), 0.0)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    else:
        o = _sdpa_plain(qf, kf, vf, None, causal, scale).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(attention_scores(qf, kf, None, causal, scale),
                              dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              seed_words: SeedWords = None):
    """The backward kernel's function in plain PyTorch, as ``_bwd2``
    computes it: ``p = exp(s - lse)`` from the saved ``lse`` (shift 0
    where it is ``NEG_INF``), ``delta = rowsum(dO * o)`` from the saved
    ``o``, the same dropout mask on ``p.V`` and ``dO.V^T``; float32 math,
    gradients in q's dtype. Given the ``o`` and ``lse`` of
    :func:`flash_attention_plain` in float32, it is that function's
    gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = attention_scores(qf, kf, None, causal, scale)
    p = torch.exp(s - torch.where(lse == NEG_INF, 0.0, lse)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    pv = p
    if dropout_rate > 0.0:
        B, H, Sq, Sk = s.shape
        mult = torch.where(attention_keep(B, H, Sq, Sk, dropout_rate,
                                          seed_words, device=q.device),
                           keep_scale(dropout_rate), 0.0)
        pv, dp = p * mult, dp * mult
    delta = (dof * of).sum(-1).transpose(1, 2)               # [B, H, Sq]
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", pv, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_args(q, k, v, causal, dropout_rate, seed_words):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    if causal and Sq > k.shape[1]:
        raise ValueError(f"causal attention with Sq={Sq} > Sk={k.shape[1]} "
                         "leaves rows with no visible key")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0 and seed_words is None:
        raise ValueError("dropout_rate > 0 needs seed_words")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        if q.dtype not in _DTYPES:
            raise ValueError(f"flash kernels take float32 or bfloat16, got "
                             f"{q.dtype}")
        if D not in (64, 128):
            raise ValueError(f"flash kernels take head_dim 64 or 128, got "
                             f"{D}")


def _dropout_args(dropout_rate: float, seed_words: SeedWords):
    """(dropout, threshold, seed, keep_scale) of the C entries."""
    if dropout_rate <= 0.0:
        return 0, 0, 0, 1.0
    return (1, keep_threshold(dropout_rate), seed_mix(seed_words),
            keep_scale(dropout_rate))


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        return_lse: bool = False,
                        dropout_rate: float = 0.0,
                        seed_words: SeedWords = None):
    """Attention over ``[B, S, H, D]`` q/k/v; returns ``o`` (q's dtype)
    or ``(o, lse)`` with ``lse [B, H, Sq]`` float32."""
    dropout_rate = float(dropout_rate)
    _check_args(q, k, v, causal, dropout_rate, seed_words)
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, return_lse,
                                     dropout_rate, seed_words)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q, k, v")
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = function(_KERNEL.name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             B, Sq, k.shape[1], H, D, int(bool(causal)), float(scale),
             *_dropout_args(dropout_rate, seed_words), _DTYPES[q.dtype],
             stream)
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0,
                        seed_words: SeedWords = None):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the output
    gradient ``do``, from its saved ``o`` and ``lse``."""
    dropout_rate = float(dropout_rate)
    _check_args(q, k, v, causal, dropout_rate, seed_words)
    B, Sq, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} must "
                         f"be q's shape and lse {tuple(lse.shape)} "
                         f"[B, H, Sq]")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                         dropout_rate, seed_words)
    ts = (q, k, v, o, do)
    if any(t.dtype != q.dtype or t.device != q.device for t in ts) \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash backward takes q, k, v, o, do in one dtype "
                         "and lse in float32, all on one device")
    if not all(t.is_contiguous() for t in ts + (lse,)):
        raise ValueError("flash backward takes contiguous arguments")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = function(_BWD.name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), B, Sq, k.shape[1], H, D,
             int(bool(causal)), float(scale),
             *_dropout_args(dropout_rate, seed_words), _DTYPES[q.dtype],
             stream)
    check(_BWD.name, err)
    _BWD.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_rate, seed_words):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, causal, scale, True,
                                     dropout_rate, seed_words)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, dropout_rate, seed_words)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    seed_words: SeedWords = None):
    """Differentiable flash attention over ``[B, S, H, D]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                float(dropout_rate), seed_words)
