"""Batched next-token sampling with per-slot parameters.

Counterpart of ``paddle_tpu/serving/sampling.py``. Conventions:
``temperature <= 0`` means greedy (argmax, first maximum wins, as
``jnp.argmax``); ``top_k <= 0`` disables the top-k filter;
``top_p >= 1`` disables nucleus filtering. Sampled rows draw from the
caller's ``torch.Generator``.

:func:`verify_draws` is what a speculative verify dispatch needs for
its sampled slots (the JAX engine's verify program,
``serving/engine.py:711-760``): each row's filtered softmax mass on the
drafted token, a full fresh sample per row and a residual redraw per
row with the draft masked out. The port cannot reproduce JAX's threefry
stream, so sampled parity between the packages is a distribution test,
not a bit test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["SamplingParams", "filtered_logits", "sample_tokens",
           "verify_draws"]

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


def _finite_rows(logits, finite=None):
    """Zero every row of ``[N, V]`` logits that holds a NaN or Inf
    (``finite``: the rows' flags, where the caller has them). The
    engine fails such a row's request on its own finiteness check; the
    draw must not stop the other rows from sampling (``multinomial``
    refuses non-finite probabilities, where JAX's ``categorical`` draws
    anyway)."""
    if finite is None:
        finite = torch.isfinite(logits).all(-1)
    return torch.where(finite[:, None], logits, 0.0)


def sample_tokens(logits, temperature, top_k, top_p,
                  generator: Optional[torch.Generator] = None,
                  finite: Optional[torch.Tensor] = None):
    """Next token per row of ``[B, V]`` logits, as int64 ``[B]``. Greedy
    rows take the argmax; the filtered sampling lane runs only when some
    row samples (``finite``: the rows' finiteness flags, if known)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    sampling = temperature > 0.0
    if not bool(sampling.any()):
        return greedy
    logits = _finite_rows(logits, finite)
    probs = torch.softmax(filtered_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(sampling, sampled, greedy)


def verify_draws(logits, drafts, temperature, top_k, top_p,
                 generator: Optional[torch.Generator] = None):
    """The stochastic-acceptance ingredients of a verify window:
    ``logits [B, S, V]`` scored over ``[last, d_1 .. d_{S-1}]`` and
    ``drafts [B, S-1]`` (int64). Returns ``(p_draft [B, S-1],
    tok_full [B, S], tok_resid [B, S-1])``: row ``i``'s filtered softmax
    mass on ``d_{i+1}``, a fresh sample from every row's filtered
    distribution, and a redraw from rows ``0 .. S-2`` with the drafted
    token masked out (the residual of a point-mass drafter)."""
    B, S, V = logits.shape
    flat = filtered_logits(_finite_rows(logits.reshape(B * S, V).float()),
                           temperature.repeat_interleave(S),
                           top_k.repeat_interleave(S),
                           top_p.repeat_interleave(S))
    probs = torch.softmax(flat, dim=-1)
    p_draft = torch.gather(probs.reshape(B, S, V)[:, :-1], 2,
                           drafts[..., None])[..., 0]
    tok_full = torch.multinomial(probs, 1, generator=generator)
    resid = flat.reshape(B, S, V)[:, :-1].scatter(2, drafts[..., None],
                                                  _NEG)
    tok_resid = torch.multinomial(
        torch.softmax(resid.reshape(B * (S - 1), V), dim=-1), 1,
        generator=generator)
    return (p_draft, tok_full.reshape(B, S),
            tok_resid.reshape(B, S - 1))
