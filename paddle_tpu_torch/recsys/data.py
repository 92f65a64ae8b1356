"""Seeded criteo-shaped synthetic workload (power-law sparse ids).

Counterpart of ``paddle_tpu/recsys/data.py``, a copy (numpy only): the
same seed gives the same batches byte for byte in both packages.

Methodology (docs/RECSYS.md): the criteo click-logs shape is
``num_dense`` float features + ``num_sparse`` categorical slots with
one id each, labels ~1 bit. Real criteo id traffic is power-law — a
handful of hot ids dominate every batch (that skew is WHY dedup lookups
and hot-ID tiering pay off) — so ids here draw from a bounded zipf:
``P(rank r) ∝ 1/(r+1)^alpha`` over each slot's vocab, rank == id (hot
ids are the small ids; deterministic, so tests can target the hot set
by construction).

Labels come from a planted logistic teacher (a fixed random linear
model over the dense features plus a per-(slot, id-bucket) embedding
score), so DLRM training has real signal to descend — the bench's
examples/s is measured on a learnable task, not noise.

Everything is seeded and batch-indexed: ``batch(i)`` is a pure function
of ``(seed, i)``, so two readers of the same config see byte-identical
streams (loadgen discipline).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

__all__ = ["CriteoSynthetic"]


class CriteoSynthetic:
    """Deterministic DLRM workload generator.

    ``vocab_sizes`` is one int (shared by every sparse slot) or a
    per-slot list. ``alpha`` is the zipf exponent (≈1.05 matches
    published criteo fits; higher = hotter head).
    """

    def __init__(self, num_dense: int = 4, num_sparse: int = 8,
                 vocab_sizes: Union[int, Sequence[int]] = 10_000,
                 alpha: float = 1.05, batch_size: int = 128,
                 seed: int = 0, teacher_buckets: int = 1024):
        self.num_dense = int(num_dense)
        self.num_sparse = int(num_sparse)
        if isinstance(vocab_sizes, (int, np.integer)):
            vocab_sizes = [int(vocab_sizes)] * self.num_sparse
        if len(vocab_sizes) != self.num_sparse:
            raise ValueError("vocab_sizes must match num_sparse")
        self.vocab_sizes: List[int] = [int(v) for v in vocab_sizes]
        self.alpha = float(alpha)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        # bounded-zipf inverse CDF per slot (float64 for a stable
        # cumsum; vocabs are bounded so the table is explicit)
        self._cdfs = []
        for v in self.vocab_sizes:
            w = 1.0 / np.power(np.arange(1, v + 1, dtype=np.float64),
                               self.alpha)
            self._cdfs.append(np.cumsum(w / w.sum()))
        # planted teacher: dense weights + per-(slot, id-bucket) scores
        trng = np.random.default_rng(self.seed ^ 0x7EC5)
        self._w_dense = trng.normal(0.0, 1.0, (self.num_dense,)) \
            .astype(np.float32)
        self._buckets = int(teacher_buckets)
        self._w_sparse = trng.normal(
            0.0, 1.0, (self.num_sparse, self._buckets)).astype(np.float32)

    def sample_ids(self, rng: np.random.Generator,
                   n: int) -> np.ndarray:
        """``[n, num_sparse]`` bounded-zipf draws — the ONE sampling
        rule, shared by :meth:`batch` and external candidate
        generators (the serving bench draws ranking candidates from
        the same distribution the tables were trained on)."""
        ids = np.empty((n, self.num_sparse), np.int64)
        for f, cdf in enumerate(self._cdfs):
            ids[:, f] = np.searchsorted(cdf, rng.random(n))
        return ids

    def batch(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch ``i`` → (dense [B, num_dense] f32, ids [B, num_sparse]
        i64, labels [B] f32) — a pure function of (seed, i)."""
        rng = np.random.default_rng((self.seed << 20) + int(i))
        B = self.batch_size
        dense = rng.normal(0.0, 1.0, (B, self.num_dense)) \
            .astype(np.float32)
        ids = self.sample_ids(rng, B)
        logit = dense @ self._w_dense
        for f in range(self.num_sparse):
            logit = logit + self._w_sparse[f, ids[:, f] % self._buckets] \
                / np.sqrt(self.num_sparse)
        prob = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(B) < prob).astype(np.float32)
        return dense, ids, labels

    def batches(self, steps: int, start: int = 0):
        for i in range(start, start + int(steps)):
            yield self.batch(i)
