"""Batched next-token sampling with per-slot parameters.

Counterpart of ``paddle_tpu/serving/sampling.py``. Conventions:
``temperature <= 0`` means greedy (argmax, first maximum wins, as
``jnp.argmax``); ``top_k <= 0`` disables the top-k filter;
``top_p >= 1`` disables nucleus filtering. Sampled rows draw from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["SamplingParams", "filtered_logits", "sample_tokens"]

_NEG = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode strategy. Defaults to greedy."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def filtered_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled, top-k/top-p-filtered ``[B, V]`` logits, the
    filtered-away entries at ``-1e30``. ``temperature``/``top_p`` are
    ``[B]`` float32, ``top_k`` ``[B]`` int."""
    logits = logits.float()
    V = logits.shape[-1]
    lg = logits / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: keep values >= the k-th largest; k <= 0 keeps all
    srt = torch.sort(lg, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, V),
                        torch.full_like(top_k, V))
    kth = torch.gather(srt, 1, (k_eff - 1).long()[:, None])
    lg = torch.where(lg < kth, _NEG, lg)
    # top-p over the k-filtered distribution: keep the smallest prefix
    # of the sorted probs whose cumulative mass reaches top_p
    srt2 = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt2, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_p[:, None], dim=-1)
    cutoff = torch.gather(srt2, 1,
                          torch.clamp(cutoff_idx, 0, V - 1).long()[:, None])
    return torch.where(lg < cutoff, _NEG, lg)


def sample_tokens(logits, temperature, top_k, top_p,
                  generator: Optional[torch.Generator] = None):
    """Next token per row of ``[B, V]`` logits, as int64 ``[B]``. Greedy
    rows take the argmax; the filtered sampling lane runs only when some
    row samples."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    sampling = temperature > 0.0
    if not bool(sampling.any()):
        return greedy
    probs = torch.softmax(filtered_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(sampling, sampled, greedy)
