"""Chunked (streamed-vocab) hard-label cross-entropy.

Counterpart of ``paddle_tpu/nn/chunked_ce.py`` for hard labels: the
per-position NLL without materialising the full-vocab float32 log-probs,
served by the chunked-CE kernels (``ops/kernels/chunked_ce.py``) on the
card, and ``masked_lm_loss``, the weighted MLM epilogue BERT and ERNIE
share (``nn/chunked_ce.py:236-259``). The JAX package reads its
threshold from a flag; here it is the flag's default as a module
constant.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.mp_ops import mp_block_group, parallel_cross_entropy
from ..distributed.spmd import count_over_data
from ..ops.kernels.chunked_ce import chunked_ce_loss

__all__ = ["CHUNKED_CE_THRESHOLD", "enabled_for", "hard_nll",
           "masked_lm_loss"]

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


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL of ``logits [..., V]`` at integer ``labels [...]``:
    streamed (:func:`hard_nll`) from ``CHUNKED_CE_THRESHOLD`` vocab
    entries, a dense float32 logsumexp below; with ``weights`` the
    weighted mean ``sum(nll * w) / max(sum(w), 1)``, the weights counted
    over every data rank inside a data-parallel ``TrainStep``
    (``spmd.count_over_data``), as the JAX mesh step takes the mean over
    the whole batch. Over a rank's vocab
    block (logits a tensor-parallel head marked) the vocab-parallel loss
    of ``mp_layers.ParallelCrossEntropy`` (``mp_ops.parallel_cross_entropy``),
    dense as the JAX loss is under an mp mesh."""
    ids = labels.long()
    group = mp_block_group(logits)
    if group is not None:
        per = parallel_cross_entropy(logits, ids, group,
                                     group.rank * logits.shape[-1])
    elif enabled_for(logits.shape[-1]):
        per = hard_nll(logits, ids)
    else:
        lg32 = logits.float()
        per = torch.logsumexp(lg32, dim=-1) - \
            lg32.gather(-1, ids[..., None])[..., 0]
    if weights is None:
        return per.mean()
    w = weights.float()
    # in a data-parallel step the weights are counted over every data
    # rank, so the ranks' average is the global batch's weighted mean
    cnt, n = count_over_data(torch.sum(w))
    num = torch.sum(per * w)
    if n > 1:
        num = num * n
    return num / torch.clamp(cnt, min=1.0)
