"""Paged flash-decode attention: wrapper of ``csrc/paged_decode.cu``.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/paged_decode.py::
paged_decode_attention`` (pallas_call at :149). Memory bandwidth bounds
it; the source's header says what the design does about it.

Given CPU tensors :func:`paged_decode_attention` computes
:func:`paged_decode_plain` — ``gather_pages`` plus masked
``_sdpa_plain``, the math of the JAX model's decode fallback
(``models/gpt.py:406-411``); given CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations


import torch

from ...serving.kv_cache import gather_pages
from ..attention import NEG_INF, _sdpa_plain
from . import PAGED_DECODE as _KERNEL
from . import check, function

__all__ = ["paged_decode_attention", "paged_decode_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_plain(q, k_pages, v_pages, block_table, pos, scale):
    """gather_pages + additive ``cols <= pos`` key mask + SDPA."""
    gk = gather_pages(k_pages, block_table)
    gv = gather_pages(v_pages, block_table)
    cols = torch.arange(gk.shape[1], device=q.device)
    mask = torch.where(cols[None, :] <= pos[:, None].long(), 0.0,
                       NEG_INF)[:, None, None, :]
    return _sdpa_plain(q[:, None], gk, gv, mask, False, scale)[:, 0]


def paged_decode_attention(q, k_pages, v_pages, block_table, pos, scale):
    """One decode step over paged KV.

    ``q`` ``[B, H, D]``; ``k_pages``/``v_pages`` ``[P, bs, H, D]``;
    ``block_table`` ``[B, MB]`` int32 page ids (each in ``[0, P)``);
    ``pos`` ``[B]`` int32, the current token's position, attended
    inclusively. Returns ``[B, H, D]`` in q's dtype."""
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
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, pos,
                                  scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in _DTYPES:
        raise ValueError("paged decode kernel takes q and pages in one "
                         "dtype, float32 or bfloat16")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("block_table and pos must be int32")
    if D not in (64, 128):
        raise ValueError(f"paged decode kernel takes head_dim 64 or 128, "
                         f"got {D}")
    ts = (q, k_pages, v_pages, block_table, pos)
    if any(t.device != q.device for t in ts):
        raise ValueError("all arguments must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged decode kernel takes contiguous arguments")
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
