"""Loss layers (counterpart of ``paddle_tpu/nn/layers/loss.py``):
``CrossEntropyLoss`` over ``nn.functional.cross_entropy``'s dense branch
(hard labels, last-axis softmax)."""

from __future__ import annotations

from .. import functional as F
from ..layer import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True,
                 label_smoothing: float = 0.0):
        super().__init__()
        if weight is not None or soft_label or axis != -1 \
                or not use_softmax or label_smoothing:
            raise NotImplementedError(
                "CrossEntropyLoss: only hard labels over the last axis "
                "with softmax, unweighted and unsmoothed, are ported")
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction)
