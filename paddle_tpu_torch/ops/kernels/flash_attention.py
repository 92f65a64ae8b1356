"""Flash attention: wrappers of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``.

Replace five TPU kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:
``_fwd2`` (pallas_call at :399) and ``_bwd2`` (:532) without a bias, and
the ``v1`` kernels that take an additive key bias ``[B, 1, 1, Sk]`` (the
padding mask of BERT and ERNIE): ``_fwd_v1`` (:239), the ``_bwd_v1`` dq
kernel (:702) and its dk/dv/dbias kernel (:753). Each source's header
says what bounds it on the card and what its design does about it.
The forward and the backward run both dtypes on the tensor cores, float32
by the error-compensated 3xTF32 split, at f32 accuracy.

All functions take ``[B, S, H, D]`` tensors and an optional in-kernel
attention dropout (``dropout_rate`` with two ``seed_words``): the keep
bit is a hash of the absolute (b, h, query row, key column) and the
words (``ops/rng.py::attention_keep``, as ``_dropout_keep`` at :87); it
masks the p.V product only, the softmax denominator keeps the undropped
p, and the backward regenerates the same mask. The bias is ``[B, Sk]``
float32 at the kernel wrappers; :func:`flash_attention` widens and
broadcasts a ``[B, 1, 1, Sk]`` mask to it, as the JAX entry does (:956).

- :func:`flash_attention_fwd` -- ``o`` or ``(o, lse)``;
- :func:`flash_attention_bwd` -- ``(dq, dk, dv)`` from q, k, v, o, lse
  and dO;
- :func:`flash_attention_bias_fwd` -- the same forward with a bias;
- :func:`flash_attention_bias_bwd_dq` -- its ``dq``;
- :func:`flash_attention_bias_bwd_dkv` -- its ``(dk, dv, db)``;
- :func:`flash_attention` -- the differentiable entry,
  ``FlashAttention`` (the ``_flash`` custom VJP at :866).

Their plain versions are :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain`, each with an optional ``bias``: the
backward reads the saved o and lse as the kernels do and returns ``db``
when given a bias; ``mxu_dtype=torch.bfloat16`` rounds the operands of
their products to bf16 as the bf16 kernels (and the TPU kernels'
``_dot``) do. They follow the kernels' online softmax, whose
running max starts at ``NEG_INF``: a row whose every score is
``NEG_INF`` or below (a fully masked row, with an f32 or a
bf16-rounded ``-1e30`` bias) gets ``o = 0`` and ``lse = NEG_INF``.

Given CPU tensors each wrapper computes its plain version; given CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..attention import NEG_INF, attention_scores
from ..rng import (attention_keep, bh_base, keep_scale, keep_threshold,
                   seed_mix)
from . import FLASH_ATTENTION_BIAS_BWD_DKV as _BIAS_DKV
from . import FLASH_ATTENTION_BIAS_BWD_DQ as _BIAS_DQ
from . import FLASH_ATTENTION_BIAS_FWD as _BIAS_FWD
from . import FLASH_ATTENTION_BWD as _BWD
from . import FLASH_ATTENTION_FWD as _KERNEL
from . import (attention_pairs, check, costing, function, note_cost,
               uncounted)

__all__ = ["flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bias_fwd", "flash_attention_bias_bwd_dq",
           "flash_attention_bias_bwd_dkv", "flash_attention_plain",
           "flash_attention_bwd_plain", "flash_attention", "FlashAttention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SeedWords = Optional[Tuple[int, int]]


def _scores(qf, kf, bias, causal, scale):
    """float32 scores ``[B, H, Sq, Sk]``: scaled, plus the bias, causal
    entries at ``NEG_INF`` or below."""
    return attention_scores(qf, kf, None if bias is None
                            else bias[:, None, None, :], causal, scale)


def _mxu_round(mxu_dtype):
    """The operand cast of the products (``_dot``'s ``cd``, :115): the
    identity for None or float32, else a round trip through
    ``mxu_dtype``."""
    if mxu_dtype is None or mxu_dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(mxu_dtype).float()


def _dropout_mult(B, H, Sq, Sk, dropout_rate, seed_words, device,
                  batch_base=0, head_base=0, row_base=0, col_base=0):
    return torch.where(attention_keep(B, H, Sq, Sk, dropout_rate, seed_words,
                                      device, batch_base, head_base,
                                      row_base, col_base),
                       keep_scale(dropout_rate), 0.0)


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None,
                          return_lse: bool = False,
                          dropout_rate: float = 0.0,
                          seed_words: SeedWords = None,
                          bias: Optional[torch.Tensor] = None,
                          mxu_dtype: Optional[torch.dtype] = None,
                          batch_base: int = 0, head_base: int = 0,
                          row_base: int = 0, col_base: int = 0):
    """The kernels' function in plain PyTorch, computed in float32 and
    returned in q's dtype (plus ``lse [B, H, Sq]`` in float32); ``bias``
    is ``[B, Sk]``. ``batch_base``, ``head_base``, ``row_base`` and
    ``col_base`` place the tensors' batch rows, heads, query rows and key
    columns in a larger tensor whose dropout mask they draw (the
    base-offset arguments of the kernels); the causal mask stays the
    launch's own.

    ``mxu_dtype`` is the operand dtype of the two products (``_dot``'s
    ``cd``, :115): None keeps float32; ``torch.bfloat16`` rounds q, k, v
    and ``pv = p * keep`` to bf16 and sums in float32, as the TPU kernels
    do under the default precision policy and as the bf16 tensor-core
    kernel does. ``l`` and ``lse`` sum the unrounded ``p``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mx = _mxu_round(mxu_dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = _scores(mx(qf), mx(kf), bias, causal, scale)
    # the kernels' running max starts at NEG_INF; a row with nothing
    # above it keeps shift 0, so its exponentials are 0
    m = s.detach().amax(-1).clamp(min=NEG_INF)
    p = torch.exp(s - torch.where(m == NEG_INF, 0.0, m)[..., None])
    l = p.sum(-1)
    safe_l = torch.where(l == 0.0, 1.0, l)
    if dropout_rate > 0.0:
        p = p * _dropout_mult(*s.shape, dropout_rate, seed_words, q.device,
                              batch_base, head_base, row_base, col_base)
    o = torch.einsum("bhqk,bkhd->bqhd", mx(p), mx(vf)) / \
        safe_l.transpose(1, 2)[..., None]
    o = o.to(q.dtype)
    if not return_lse:
        return o
    return o, torch.where(l == 0.0, NEG_INF, m + torch.log(safe_l))


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              seed_words: SeedWords = None,
                              bias: Optional[torch.Tensor] = None,
                              mxu_dtype: Optional[torch.dtype] = None,
                              batch_base: int = 0, head_base: int = 0,
                              row_base: int = 0, col_base: int = 0):
    """The backward kernels' function in plain PyTorch, as ``_bwd2`` and
    ``_bwd_v1`` compute it: ``p = exp(s - lse)`` from the saved ``lse``
    (shift 0 where it is ``NEG_INF``), ``delta = rowsum(dO * o)`` from the
    saved ``o``, the same dropout mask on ``p.V`` and ``dO.V^T``; float32
    math, gradients in q's dtype. Returns ``(dq, dk, dv)``, and with a
    ``bias [B, Sk]`` also ``db [B, Sk]`` float32 (the score gradient
    summed over heads and query rows, ``:651`` and ``:769``). Given the
    ``o`` and ``lse`` of :func:`flash_attention_plain` in float32, it is
    that function's gradient.

    ``mxu_dtype`` is the operand dtype of the five products (``_dot``'s
    ``cd``, :115): None keeps float32; ``torch.bfloat16`` rounds every
    operand, ``pv`` and ``ds`` included, to bf16 and sums in float32, as
    the TPU kernels do under the default precision policy and as the bf16
    tensor-core kernels do. ``db`` sums the unrounded ``ds / scale``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mx = _mxu_round(mxu_dtype)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = _scores(mx(qf), mx(kf), bias, causal, scale)
    p = torch.exp(s - torch.where(lse == NEG_INF, 0.0, lse)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", mx(dof), mx(vf))
    pv = p
    if dropout_rate > 0.0:
        mult = _dropout_mult(*s.shape, dropout_rate, seed_words, q.device,
                             batch_base, head_base, row_base, col_base)
        pv, dp = p * mult, dp * mult
    delta = (dof * of).sum(-1).transpose(1, 2)               # [B, H, Sq]
    dsr = p * (dp - delta[..., None])
    ds = mx(dsr * scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, mx(kf))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, mx(qf))
    dv = torch.einsum("bhqk,bqhd->bkhd", mx(pv), mx(dof))
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if bias is None:
        return grads
    return grads + (dsr.sum((1, 2)),)


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


def _check_bias(bias, q, k):
    B, Sk = q.shape[0], k.shape[1]
    if bias.shape != (B, Sk) or bias.dtype != torch.float32 \
            or bias.device != q.device:
        raise ValueError(f"the key bias must be [B={B}, Sk={Sk}] float32 on "
                         f"q's device, got {tuple(bias.shape)} {bias.dtype} "
                         f"on {bias.device}")


def _check_saved(q, k, v, o, lse, do, bias=None):
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} must "
                         f"be q's shape and lse {tuple(lse.shape)} "
                         f"[B, H, Sq]")
    if q.device.type == "cpu":
        return
    if any(t.dtype != q.dtype or t.device != q.device for t in (o, do)) \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash backward takes q, k, v, o, do in one dtype "
                         "and lse in float32, all on one device")
    rows = (q, k, v, o, do)
    extra = (lse,) if bias is None else (lse, bias)
    _check_layout("flash backward", rows + extra, rows)


def _check_layout(what, cuda_args, rows):
    """Contiguous arguments, and 16-byte aligned ``rows``: the tensors
    whose rows the kernel copies in 16-byte pieces (q, k, v, and the
    backward's o and dO, in either dtype)."""
    if not all(t.is_contiguous() for t in cuda_args):
        raise ValueError(f"{what} takes contiguous arguments")
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError(f"the {what} takes 16-byte aligned tensors")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dropout_args(dropout_rate: float, seed_words: SeedWords):
    """(dropout, threshold, seed, keep_scale) of the C entries."""
    if dropout_rate <= 0.0:
        return 0, 0, 0, 1.0
    return (1, keep_threshold(dropout_rate), seed_mix(seed_words),
            keep_scale(dropout_rate))


def _u32(x: int) -> int:
    return int(x) & 0xFFFFFFFF


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _note_fwd(name, q, k, causal, bias, return_lse):
    """A forward's work (``chip_smoke.py``'s bound): q.k and p.v over the
    visible pairs; q, k, v read, o written, the bias and lse rows."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    nbytes = 2 * B * (Sq + Sk) * H * D * q.element_size()
    if bias is not None:
        nbytes += B * Sk * 4
    if return_lse:
        nbytes += B * H * Sq * 4
    note_cost(name, 4 * D * attention_pairs(B, H, Sq, Sk, causal, bias),
              nbytes)


def _note_bias_bwd(name, q, k, causal, bias, flops_per, q_rows, k_rows,
                   bias_rows):
    """A biased backward kernel's work: ``flops_per * D`` a visible
    pair; ``q_rows`` tensors of q's shape (q, o, dO, dq) and ``k_rows``
    of k's (k, v, dk, dv), ``bias_rows`` f32 ``[B, Sk]`` rows (bias, db)
    and the lse read."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    elem = q.element_size()
    note_cost(name, flops_per * D * attention_pairs(B, H, Sq, Sk, causal,
                                                    bias),
              (q_rows * Sq + k_rows * Sk) * B * H * D * elem
              + bias_rows * B * Sk * 4 + B * H * Sq * 4)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        return_lse: bool = False,
                        dropout_rate: float = 0.0,
                        seed_words: SeedWords = None,
                        batch_base: int = 0, head_base: int = 0,
                        row_base: int = 0, col_base: int = 0):
    """Attention over ``[B, S, H, D]`` q/k/v; returns ``o`` (q's dtype)
    or ``(o, lse)`` with ``lse [B, H, Sq]`` float32. The dropout mask is
    that of batch rows ``batch_base..``, heads ``head_base..``, query
    rows ``row_base..`` and key columns ``col_base..`` of a larger tensor
    (all 0: the tensor itself)."""
    dropout_rate = float(dropout_rate)
    _check_args(q, k, v, causal, dropout_rate, seed_words)
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if costing():
        _note_fwd(_KERNEL.name, q, k, causal, None, return_lse)
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_plain(
                q, k, v, causal, scale, return_lse, dropout_rate, seed_words,
                batch_base=batch_base, head_base=head_base,
                row_base=row_base, col_base=col_base)
    _check_layout("flash forward", (q, k, v), (q, k, v))
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = function(_KERNEL.name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, Sq, k.shape[1], H, D, int(bool(causal)), float(scale),
        *_dropout_args(dropout_rate, seed_words),
        bh_base(batch_base, head_base), _u32(row_base), _u32(col_base),
        _DTYPES[q.dtype], _stream(q))
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None,
                        dropout_rate: float = 0.0,
                        seed_words: SeedWords = None,
                        batch_base: int = 0, head_base: int = 0,
                        row_base: int = 0, col_base: int = 0):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the output
    gradient ``do``, from its saved ``o`` and ``lse``, with the same
    dropout bases."""
    dropout_rate = float(dropout_rate)
    _check_args(q, k, v, causal, dropout_rate, seed_words)
    _check_saved(q, k, v, o, lse, do)
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if costing():
        Sk = k.shape[1]
        note_cost(_BWD.name, 10 * D * attention_pairs(B, H, Sq, Sk, causal),
                  4 * B * (Sq + Sk) * H * D * q.element_size()
                  + B * H * Sq * 4)
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale, dropout_rate, seed_words,
                batch_base=batch_base, head_base=head_base,
                row_base=row_base, col_base=col_base)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = function(_BWD.name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Sq, k.shape[1], H, D,
        int(bool(causal)), float(scale),
        *_dropout_args(dropout_rate, seed_words),
        bh_base(batch_base, head_base), _u32(row_base), _u32(col_base),
        _DTYPES[q.dtype], _stream(q))
    check(_BWD.name, err)
    _BWD.launches += 1
    return dq, dk, dv


def flash_attention_bias_fwd(q, k, v, bias, causal: bool = False,
                             scale: Optional[float] = None,
                             return_lse: bool = False,
                             dropout_rate: float = 0.0,
                             seed_words: SeedWords = None,
                             batch_base: int = 0, head_base: int = 0):
    """:func:`flash_attention_fwd` with ``bias [B, Sk]`` float32 added to
    the scaled scores of every query row (``_fwd_v1``); the dropout mask
    of batch rows ``batch_base..`` and heads ``head_base..``."""
    dropout_rate = float(dropout_rate)
    _check_args(q, k, v, causal, dropout_rate, seed_words)
    _check_bias(bias, q, k)
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if costing():
        _note_fwd(_BIAS_FWD.name, q, k, causal, bias, return_lse)
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_plain(q, k, v, causal, scale, return_lse,
                                         dropout_rate, seed_words, bias,
                                         batch_base=batch_base,
                                         head_base=head_base)
    _check_layout("flash forward", (q, k, v, bias), (q, k, v))
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = function(_BIAS_FWD.name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr() if lse is not None else None,
        B, Sq, k.shape[1], H, D, int(bool(causal)), float(scale),
        *_dropout_args(dropout_rate, seed_words),
        bh_base(batch_base, head_base), _DTYPES[q.dtype], _stream(q))
    check(_BIAS_FWD.name, err)
    _BIAS_FWD.launches += 1
    return (o, lse) if return_lse else o


def _bias_bwd_args(q, k, v, bias, o, lse, do, causal, dropout_rate,
                   seed_words):
    dropout_rate = float(dropout_rate)
    _check_args(q, k, v, causal, dropout_rate, seed_words)
    _check_bias(bias, q, k)
    _check_saved(q, k, v, o, lse, do, bias)
    return dropout_rate


def flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do,
                                causal: bool = False,
                                scale: Optional[float] = None,
                                dropout_rate: float = 0.0,
                                seed_words: SeedWords = None,
                                batch_base: int = 0, head_base: int = 0):
    """``dq`` of :func:`flash_attention_bias_fwd` for the output gradient
    ``do``, from its saved ``o`` and ``lse`` (the ``_bwd_v1`` dq
    kernel), with the forward's dropout bases."""
    dropout_rate = _bias_bwd_args(q, k, v, bias, o, lse, do, causal,
                                  dropout_rate, seed_words)
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if costing():
        _note_bias_bwd(_BIAS_DQ.name, q, k, causal, bias, 6, 4, 2, 1)
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale, dropout_rate, seed_words,
                                             bias, batch_base=batch_base,
                                             head_base=head_base)[0]
    dq = torch.empty_like(q)
    err = function(_BIAS_DQ.name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
        B, Sq, k.shape[1], H, D, int(bool(causal)), float(scale),
        *_dropout_args(dropout_rate, seed_words),
        bh_base(batch_base, head_base), _DTYPES[q.dtype], _stream(q))
    check(_BIAS_DQ.name, err)
    _BIAS_DQ.launches += 1
    return dq


def flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 dropout_rate: float = 0.0,
                                 seed_words: SeedWords = None,
                                 batch_base: int = 0, head_base: int = 0):
    """``(dk, dv, db)`` of :func:`flash_attention_bias_fwd`, ``db [B, Sk]``
    float32 (the ``_bwd_v1`` dk/dv kernel and its head sum), with the
    forward's dropout bases."""
    dropout_rate = _bias_bwd_args(q, k, v, bias, o, lse, do, causal,
                                  dropout_rate, seed_words)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if costing():
        _note_bias_bwd(_BIAS_DKV.name, q, k, causal, bias, 8, 3, 4, 2)
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale, dropout_rate, seed_words,
                                             bias, batch_base=batch_base,
                                             head_base=head_base)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    db_h = torch.empty((B, H, Sk), dtype=torch.float32, device=q.device)
    db = torch.empty((B, Sk), dtype=torch.float32, device=q.device)
    err = function(_BIAS_DKV.name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), db_h.data_ptr(), db.data_ptr(), B, Sq, Sk, H, D,
        int(bool(causal)), float(scale),
        *_dropout_args(dropout_rate, seed_words),
        bh_base(batch_base, head_base), _DTYPES[q.dtype], _stream(q))
    check(_BIAS_DKV.name, err)
    _BIAS_DKV.launches += 1
    return dk, dv, db


class FlashAttention(torch.autograd.Function):
    """Flash attention with the backward kernels as its gradient; with a
    ``bias [B, Sk]`` float32 the ``v1`` kernels, which return its
    gradient too."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, dropout_rate, seed_words,
                batch_base=0, head_base=0):
        q, k, v = (_aligned(t) for t in (q, k, v))
        args = (causal, scale, True, dropout_rate, seed_words)
        ctx.bases = (batch_base, head_base)
        if bias is None:
            o, lse = flash_attention_fwd(q, k, v, *args,
                                         batch_base=batch_base,
                                         head_base=head_base)
        else:
            bias = bias.contiguous()
            o, lse = flash_attention_bias_fwd(q, k, v, bias, *args,
                                              batch_base=batch_base,
                                              head_base=head_base)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.args = (causal, scale, dropout_rate, seed_words)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = _aligned(do)
        bases = dict(batch_base=ctx.bases[0], head_base=ctx.bases[1])
        if bias is None:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args,
                                             **bases)
            db = None
        else:
            dq = flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do,
                                             *ctx.args, **bases)
            dk, dv, db = flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse,
                                                      do, *ctx.args, **bases)
        return dq, dk, dv, db, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    seed_words: SeedWords = None,
                    bias: Optional[torch.Tensor] = None,
                    batch_base: int = 0, head_base: int = 0):
    """Differentiable flash attention over ``[B, S, H, D]``; ``bias`` is
    an additive key mask that broadcasts to ``[B, 1, 1, Sk]``, widened to
    float32 as the JAX entry does (its gradient comes back in its own
    dtype). ``batch_base`` / ``head_base``: the dropout mask of these
    rows and heads in a larger batch (a data- or tensor-parallel rank's
    slice), with or without a bias."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if bias is not None:
        B, Sk = q.shape[0], k.shape[1]
        bias = bias.float().expand(B, 1, 1, Sk).reshape(B, Sk)
    return FlashAttention.apply(q, k, v, bias, bool(causal), float(scale),
                                float(dropout_rate), seed_words,
                                int(batch_base), int(head_base))
