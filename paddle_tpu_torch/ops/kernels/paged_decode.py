"""Paged flash-decode attention: wrappers of ``csrc/paged_decode.cu``.

Replaces the TPU kernels ``paddle_tpu/ops/pallas/paged_decode.py::
paged_decode_attention`` (pallas_call at :149) and
``::paged_decode_attention_quant`` (pallas_call at :199, int8 pools with
f32 scales). Memory bandwidth bounds both; the source's header says
what the design does about it.

Given CPU tensors :func:`paged_decode_attention` computes
:func:`paged_decode_plain` — ``gather_pages`` plus masked
``_sdpa_plain``, the math of the JAX model's decode fallback
(``models/gpt.py:406-411``) — and :func:`paged_decode_attention_quant`
computes :func:`paged_decode_quant_plain`, the same over
``gather_pages_quant`` (``models/gpt.py:385-390``); given CUDA tensors
each launches its kernel or raises.
"""

from __future__ import annotations


import torch

from ...serving.kv_cache import gather_pages, gather_pages_quant
from ..attention import NEG_INF, _sdpa_plain
from . import PAGED_DECODE as _KERNEL
from . import PAGED_DECODE_QUANT as _QKERNEL
from . import check, function

__all__ = ["paged_decode_attention", "paged_decode_plain",
           "paged_decode_attention_quant", "paged_decode_quant_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _attend_gathered(q, gk, gv, pos, scale):
    """Additive ``cols <= pos`` key mask + SDPA over a gathered
    context."""
    cols = torch.arange(gk.shape[1], device=q.device)
    mask = torch.where(cols[None, :] <= pos[:, None].long(), 0.0,
                       NEG_INF)[:, None, None, :]
    return _sdpa_plain(q[:, None], gk, gv, mask, False, scale)[:, 0]


def paged_decode_plain(q, k_pages, v_pages, block_table, pos, scale):
    """gather_pages + additive ``cols <= pos`` key mask + SDPA."""
    return _attend_gathered(q, gather_pages(k_pages, block_table),
                            gather_pages(v_pages, block_table), pos, scale)


def paged_decode_quant_plain(q, k_pages, k_scales, v_pages, v_scales,
                             block_table, pos, scale):
    """gather_pages_quant + additive ``cols <= pos`` key mask + SDPA."""
    return _attend_gathered(
        q, gather_pages_quant(k_pages, k_scales, block_table),
        gather_pages_quant(v_pages, v_scales, block_table), pos, scale)


def _check_common(q, k_pages, v_pages, block_table, pos):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} [B,H,D], pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         "[P,bs,H,D]")
    B, H, D = q.shape
    if k_pages.shape[2:] != (H, D):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not hold "
                         f"H={H}, D={D}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or pos.shape != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={B}")


def _check_card(ts, D):
    """What a CUDA launch of either kernel needs besides dtypes; ``ts``
    runs from q to the block table and pos."""
    q, block_table, pos = ts[0], ts[-2], ts[-1]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("block_table and pos must be int32")
    if D not in (64, 128):
        raise ValueError(f"paged decode kernel takes head_dim 64 or 128, "
                         f"got {D}")
    if any(t.device != q.device for t in ts):
        raise ValueError("all arguments must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged decode kernel takes contiguous arguments")


def paged_decode_attention(q, k_pages, v_pages, block_table, pos, scale):
    """One decode step over paged KV.

    ``q`` ``[B, H, D]``; ``k_pages``/``v_pages`` ``[P, bs, H, D]``;
    ``block_table`` ``[B, MB]`` int32 page ids (each in ``[0, P)``);
    ``pos`` ``[B]`` int32, the current token's position, attended
    inclusively. Returns ``[B, H, D]`` in q's dtype."""
    _check_common(q, k_pages, v_pages, block_table, pos)
    B, H, D = q.shape
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, pos,
                                  scale)
    ts = (q, k_pages, v_pages, block_table, pos)
    _check_card(ts, D)
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in _DTYPES:
        raise ValueError("paged decode kernel takes q and pages in one "
                         "dtype, float32 or bfloat16")
    out = torch.empty_like(q)
    fn = function(_KERNEL.name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             B, H, D, k_pages.shape[1], block_table.shape[1], float(scale),
             _DTYPES[q.dtype], stream)
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return out


def paged_decode_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                 block_table, pos, scale):
    """One decode step over an int8 paged pool
    (``FLAGS_serve_kv_quant=int8``): the contract of
    :func:`paged_decode_attention` with int8 ``k_pages``/``v_pages``
    ``[P, bs, H, D]`` and their f32 scales ``[P, bs, H]``; each K/V row
    is ``int8 * scale``. ``q`` is float32 ``[B, H, D]``; returns
    ``[B, H, D]`` float32."""
    _check_common(q, k_pages, v_pages, block_table, pos)
    B, H, D = q.shape
    P, bs = k_pages.shape[:2]
    if k_scales.shape != (P, bs, H) or v_scales.shape != (P, bs, H):
        raise ValueError(f"scales {tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)} are not [P,bs,H] = "
                         f"{(P, bs, H)}")
    if q.device.type == "cpu":
        return paged_decode_quant_plain(q, k_pages, k_scales, v_pages,
                                        v_scales, block_table, pos, scale)
    ts = (q, k_pages, k_scales, v_pages, v_scales, block_table, pos)
    _check_card(ts, D)
    if q.dtype != torch.float32 or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8 \
            or k_scales.dtype != torch.float32 \
            or v_scales.dtype != torch.float32:
        raise ValueError("quantized paged decode kernel takes float32 q, "
                         "int8 pages and float32 scales")
    out = torch.empty_like(q)
    fn = function(_QKERNEL.name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
             v_pages.data_ptr(), v_scales.data_ptr(), block_table.data_ptr(),
             pos.data_ptr(), out.data_ptr(), B, H, D, bs,
             block_table.shape[1], float(scale), stream)
    check(_QKERNEL.name, err)
    _QKERNEL.launches += 1
    return out
