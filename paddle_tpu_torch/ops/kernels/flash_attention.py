"""Flash-attention forward: wrapper of ``csrc/flash_attention_fwd.cu``.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py::
_fwd2`` (pallas_call at :399). The card bounds it by arithmetic at the
serving shapes; the source's header says what the design does about it.

:func:`flash_attention_fwd` takes ``[B, S, H, D]`` tensors. Given CPU
tensors it computes :func:`flash_attention_plain` (the port's
``_sdpa_plain``); given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..attention import _sdpa_plain, attention_scores
from . import FLASH_ATTENTION_FWD as _KERNEL
from . import check, function

__all__ = ["flash_attention_fwd", "flash_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch, computed in float32 and
    returned in q's dtype (plus ``lse [B, H, Sq]`` in float32)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    o = _sdpa_plain(qf, kf, vf, None, causal, scale).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(attention_scores(qf, kf, None, causal, scale),
                              dim=-1)


def _check_args(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes [B, S, H, D] tensors")
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


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Attention over ``[B, S, H, D]`` q/k/v; returns ``o`` (q's dtype)
    or ``(o, lse)`` with ``lse [B, H, Sq]`` float32."""
    _check_args(q, k, v, causal)
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {D}")
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
             _DTYPES[q.dtype], stream)
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return (o, lse) if return_lse else o
