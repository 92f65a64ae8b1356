"""Batched gather-matmul for multi-tenant LoRA: wrapper of
``csrc/bgmv.cu``.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/bgmv.py::bgmv``
(pallas_call at :103): each batch row applies the low-rank adapter its
``ids`` entry picks out of the stacked pools, shrink then expand, in
f32. Memory bandwidth bounds it; the source's header says what the
design does about it.

Given CPU tensors :func:`bgmv` computes :func:`bgmv_plain` — the
``bgmv_xla`` oracle of the JAX package (``bgmv.py:49-65``): gather each
row's adapter, then two f32 einsums; given CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import BGMV as _KERNEL
from . import check, costing, function, note_cost, uncounted

__all__ = ["bgmv", "bgmv_plain", "MAX_RANK"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest rank the kernel keeps in shared memory (RMAX in the source)
MAX_RANK = 64


def bgmv_plain(x, a, b, ids):
    """Gather each row's adapter, then shrink + expand in f32."""
    t = ids.long()
    h = torch.einsum("bse,bre->bsr", x.float(), a[t].float())
    out = torch.einsum("bsr,bro->bso", h, b[t].float())
    return out.to(x.dtype)


def bgmv(x, a, b, ids):
    """``delta[i] = (x[i] @ a[ids[i]].T) @ b[ids[i]]``.

    ``x`` ``[B, S, E]``; ``a`` ``[A, r, E]``; ``b`` ``[A, r, O]``;
    ``ids`` ``[B]`` int32 adapter rows, each in ``[0, A)`` (row 0 the
    zero adapter). Returns ``[B, S, O]`` in x's dtype. On the card x is
    float32 or bfloat16 and the pools float32, as the serving engine
    keeps them."""
    if x.dim() != 3 or a.dim() != 3 or b.dim() != 3 \
            or a.shape[:2] != b.shape[:2] or a.shape[2] != x.shape[2]:
        raise ValueError(f"shapes: x {tuple(x.shape)} [B,S,E], a "
                         f"{tuple(a.shape)} [A,r,E], b {tuple(b.shape)} "
                         "[A,r,O]")
    B, S, E = x.shape
    r, O = b.shape[1], b.shape[2]
    if ids.shape != (B,):
        raise ValueError(f"ids {tuple(ids.shape)} do not match B={B}")
    if costing():
        # the adapter rows gathered: reads the ids back (one sync)
        with uncounted():
            rows = int(torch.unique(ids).numel())
        note_cost(_KERNEL.name, 2 * B * S * r * (E + O),
                  (B * S * E + B * S * O) * x.element_size()
                  + rows * r * (E + O) * a.element_size() + 4 * B)
    if x.device.type == "cpu":
        with uncounted():
            return bgmv_plain(x, a, b, ids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise ValueError("bgmv kernel takes x in float32 or bfloat16 and "
                         "float32 pools")
    if ids.dtype != torch.int32:
        raise ValueError("ids must be int32")
    if r > MAX_RANK:
        raise ValueError(f"bgmv kernel holds ranks up to {MAX_RANK}, "
                         f"got {r}")
    ts = (x, a, b, ids)
    if any(t.device != x.device for t in ts):
        raise ValueError("all arguments must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("bgmv kernel takes contiguous arguments")
    out = torch.empty((B, S, O), dtype=x.dtype, device=x.device)
    fn = function(_KERNEL.name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
             out.data_ptr(), B, S, E, r, O, _DTYPES[x.dtype], stream)
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return out
