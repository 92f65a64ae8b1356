"""Chunked (streamed-vocab) hard-label cross-entropy.

Counterpart of ``paddle_tpu/nn/chunked_ce.py`` for hard labels: the
per-position NLL without materialising the full-vocab float32 log-probs,
served by the chunked-CE kernels (``ops/kernels/chunked_ce.py``) on the
card. The JAX package reads its threshold from a flag; here it is the
flag's default as a module constant.
"""

from __future__ import annotations

import torch

from ..ops.kernels.chunked_ce import chunked_ce_loss

__all__ = ["CHUNKED_CE_THRESHOLD", "enabled_for", "hard_nll"]

#: vocab size from which the streamed path serves the loss
CHUNKED_CE_THRESHOLD = 4096


def enabled_for(vocab_size: int) -> bool:
    """True when the streamed path should serve this vocab size."""
    return int(vocab_size) >= CHUNKED_CE_THRESHOLD


def hard_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Streamed per-position NLL: ``logits [..., V]``, integer ``labels
    [...]`` (the caller maps ignored labels to a safe id and masks the
    result). Returns float32 ``[...]``."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    loss = chunked_ce_loss(logits.reshape(-1, V),
                           labels.reshape(-1).to(torch.int32))
    return loss.reshape(lead)
