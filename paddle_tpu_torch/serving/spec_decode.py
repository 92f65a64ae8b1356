"""Self-drafting speculative decoding: n-gram prompt-lookup proposals
verified in one batched dispatch.

Counterpart of ``paddle_tpu/serving/spec_decode.py`` (pure Python, so
the port keeps its own copy). The verifier is the serving model itself:
ONE context-prefill-shaped dispatch scores all ``k+1`` positions of
``[last_token, d_1 .. d_k]`` against the paged cache, so accepted
tokens cost ``1/(n_acc+1)`` dispatches each. The drafter is
**prompt-lookup** (Saxena 2023): propose the continuation of the most
recent earlier occurrence of the sequence's own trailing n-gram. No
second model, no extra weights, no device work.

Greedy acceptance is exact by construction: draft ``d_i`` is accepted
iff it equals the verifier's argmax at position ``i-1``, so the
committed stream is the token-for-token greedy output of the plain
decode loop. Sampled slots accept stochastically (``serving.engine``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["propose_ngram"]


def propose_ngram(tokens: Sequence[int], k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> np.ndarray:
    """Up to ``k`` draft tokens continuing ``tokens`` by prompt lookup.

    Tries the longest trailing n-gram first (``max_ngram`` down to
    ``min_ngram``): if it occurred earlier in ``tokens``, the tokens
    that FOLLOWED its most recent earlier occurrence are the draft.
    Returns an empty array when no n-gram recurs — the slot decodes
    plainly this iteration (zero wasted compute, the drafter is free).
    """
    toks = np.asarray(tokens, np.int64).reshape(-1)
    T = toks.size
    if k <= 0 or T < min_ngram + 1:
        return np.zeros((0,), np.int32)
    for n in range(min(max_ngram, T - 1), min_ngram - 1, -1):
        suffix = toks[T - n:]
        # windows [i, i+n) for i in 0..T-n-1: every PRIOR occurrence
        # (the trailing window itself is excluded)
        win = np.lib.stride_tricks.sliding_window_view(toks, n)[:T - n]
        hits = np.flatnonzero((win == suffix).all(axis=1))
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n          # most recent occurrence
        draft = toks[start:start + k]
        if draft.size:
            return draft.astype(np.int32)
    return np.zeros((0,), np.int32)
