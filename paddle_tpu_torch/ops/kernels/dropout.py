"""Fused dropout: wrapper of ``csrc/dropout.cu``.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/dropout.py::_run``
(pallas_call at :69). Memory bounds it; the source's header says what
the design does about it.

:func:`fused_dropout` is ``upscale_in_train`` dropout of a tensor of any
shape: ``x * keep * inv`` with the keep bit a hash of the flat element
index and the seed words (``ops/rng.py``) and ``inv = 1/(1 - rate)``
rounded to x's dtype first, as ``x * jnp.asarray(inv, x.dtype)`` at
``dropout.py:54`` (1.109375 in bf16, not 1.1111). It is differentiable:
the backward reruns the same function on the gradient, as
``_dropout_bwd`` at :89 does, so no mask is stored. Given a CPU tensor
it computes :func:`dropout_plain`; given a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..rng import dropout_keep, keep_threshold, seed_mix
from . import FUSED_DROPOUT as _KERNEL
from . import check, function

__all__ = ["fused_dropout", "dropout_plain", "dropout_apply"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _inv(rate: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(1.0 / (1.0 - rate)).to(dtype))


def dropout_plain(x: torch.Tensor, rate: float,
                  seed_words: Tuple[int, int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bit for bit."""
    keep = dropout_keep(x.numel(), rate, seed_words,
                        device=x.device).reshape(x.shape)
    inv = torch.tensor(_inv(rate, x.dtype), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * inv, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def dropout_apply(x: torch.Tensor, rate: float,
                  seed_words: Tuple[int, int]) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor (the plain version on a
    CPU tensor); not differentiable. Both passes of
    :func:`fused_dropout` call it."""
    if x.device.type == "cpu":
        return dropout_plain(x, rate, seed_words)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dropout kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    fn = function(_KERNEL.name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), x.numel(), seed_mix(seed_words),
             keep_threshold(rate), _inv(rate, x.dtype), _DTYPES[x.dtype],
             stream)
    check(_KERNEL.name, err)
    _KERNEL.launches += 1
    return y


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed_words):
        ctx.args = (rate, seed_words)
        return dropout_apply(x, rate, seed_words)

    @staticmethod
    def backward(ctx, g):
        # d(drop(x))/dx is the same mask and scale: rerun it on g
        return dropout_apply(g, *ctx.args), None, None


def fused_dropout(x: torch.Tensor, rate: float,
                  seed_words: Tuple[int, int]) -> torch.Tensor:
    """Single-pass ``upscale_in_train`` dropout of ``x`` (any shape)."""
    rate = float(rate)
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return _FusedDropout.apply(x, rate, tuple(int(w) for w in seed_words))
