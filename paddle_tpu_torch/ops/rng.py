"""The stateless dropout hash, in plain PyTorch.

Counterpart of ``paddle_tpu/ops/pallas/rng.py`` (``fmix32``,
``keep_threshold``) and of the keep masks built on it:
``ops/pallas/dropout.py::_keep_mask`` (flat element index) and
``ops/pallas/flash_attention.py::_dropout_keep`` (absolute batch, head,
query row and key column). The CUDA kernels compute the same bits
(``csrc/dropout_hash.cuh``); these are their plain versions.

Torch has no full uint32 arithmetic, so values live in int64 and every
product is taken as two 16-bit halves and masked to 32 bits: each
partial product stays below 2**49, and nothing overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["fmix32", "keep_threshold", "keep_scale", "seed_mix",
           "dropout_keep", "attention_keep"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` in wrapping uint32 arithmetic (x int64 in [0, 2**32))."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """uint32 threshold with P(hash >= t) = 1 - rate: the integer that
    ``jnp.uint32(min(rate, 0.999999) * 4294967296.0)`` truncates to."""
    return int(min(float(rate), 0.999999) * 4294967296.0)


def keep_scale(rate: float) -> float:
    """``1 / (1 - rate)`` as the attention kernels apply it: the float32
    quotient of 1 by ``float32(1 - rate)``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(1.0 - float(rate), dtype=torch.float32))


def seed_mix(seed_words: Tuple[int, int]) -> int:
    """``s0 ^ (s1 << 1)`` in uint32, the seed term of every keep hash."""
    s0, s1 = (int(w) & _M32 for w in seed_words)
    return (s0 ^ (s1 << 1)) & _M32


def dropout_keep(n: int, rate: float, seed_words: Tuple[int, int],
                 device=None) -> torch.Tensor:
    """Keep bits ``[n]`` (bool) of the fused dropout kernel over the flat
    element indices 0..n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device) & _M32
    h = fmix32(_mul32(idx, 0x9E3779B1) ^ seed_mix(seed_words))
    return h >= keep_threshold(rate)


def attention_keep(B: int, H: int, Sq: int, Sk: int, rate: float,
                   seed_words: Tuple[int, int], device=None) -> torch.Tensor:
    """Keep bits ``[B, H, Sq, Sk]`` (bool) of the flash kernels'
    attention dropout at absolute (b, h, query row, key column)."""
    rows = _mul32(torch.arange(Sq, dtype=torch.int64, device=device),
                  0x9E3779B1)
    cols = _mul32(torch.arange(Sk, dtype=torch.int64, device=device),
                  0x85EBCA6B)
    b = _mul32(torch.arange(B, dtype=torch.int64, device=device),
               0xAC564B05)
    h = _mul32(torch.arange(H, dtype=torch.int64, device=device), 19349663)
    bh = ((b[:, None] + h[None, :]) & _M32) ^ seed_mix(seed_words)
    x = rows[:, None] ^ cols[None, :]
    return fmix32(x[None, None] ^ bh[:, :, None, None]) >= \
        keep_threshold(rate)
