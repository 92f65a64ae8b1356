"""ERNIE: encoder with task-type embeddings, MLM and sentence-order
heads, PyTorch port.

Counterpart of ``paddle_tpu/models/ernie.py``: the BERT encoder
(``models/bert.py``'s post-LN stack, pooler and tied MLM head) with a
task-type embedding added to the input sum when ``task_type_ids`` are
given, and ``ErnieForPretraining``'s sentence-order prediction (SOP)
head; its loss is the weighted MLM loss plus the dense 2-class
cross-entropy of the SOP head (:162-176). Names, dtypes under O1 and
initializers follow the JAX package as BERT's do. The JAX package's
``ErnieEmbeddings`` is ``bert.BertEmbeddings`` built with
``task_type_vocab_size``, and ``ErnieModel`` is ``bert.BertModel`` over
those embeddings. :func:`ernie_3_1p5b` is BASELINE config 5's model
(ERNIE-3.0 1.5B), trained over sharding x mp through
``apply_hybrid_specs`` (the tensor-parallel route of ``models/bert.py``;
``mesh=`` builds each rank's blocks only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.random import dropout_generator
from ..distributed.meta_parallel.parallel_layers.mp_layers import MPModule
from ..nn import functional as F
from ..nn.chunked_ce import masked_lm_loss
from ..nn.layers import LayerNorm, Linear
from .bert import BertModel, _vocab_group, build, mlm_head

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForPretraining", "ernie_tiny",
           "ernie_base", "ernie_3_1p5b"]


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 513
    type_vocab_size: int = 2
    task_type_vocab_size: int = 3
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02


class ErnieModel(BertModel):
    """BERT's embeddings with the task-type table, post-LN encoder and
    tanh pooler; ``forward`` takes ``task_type_ids`` after
    ``position_ids`` and returns ``(seq, pooled)``."""

    def __init__(self, cfg: ErnieConfig, device: torch.device):
        super().__init__(cfg, device, cfg.task_type_vocab_size)


class ErnieForPretraining(MPModule):
    """MLM head (tied decoder) + sentence-order prediction head. Built on
    ``device`` (the card unless ``device="cpu"`` is passed) with weights
    drawn from ``seed``; with ``mesh=`` cut to this rank's blocks of the
    hybrid specs as it is built (``models/bert.py``)."""

    def __init__(self, cfg: ErnieConfig, device: DeviceLike = None,
                 seed: int = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        at = "meta" if mesh is not None else dev
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, at)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, at)
        self.transform_norm = LayerNorm(cfg.hidden_size, at)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     device=at))
        self.sop_head = Linear(cfg.hidden_size, 2, at)
        build(self, cfg, dev, seed, mesh)

    def _on_mesh(self, mesh) -> None:
        self.mp_group = _vocab_group(
            mesh, self.ernie.embeddings.word_embeddings.weight)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None, task_type_ids=None,
                generator: Optional[torch.Generator] = None):
        """``(mlm_scores [B, M, V], sop_scores [B, 2])``; ``generator`` as
        in ``BertForMaskedLM.forward``."""
        if generator is not None:
            with dropout_generator(generator):
                return self.forward(input_ids, token_type_ids,
                                    attention_mask, masked_positions,
                                    task_type_ids)
        seq, pooled = self.ernie(input_ids, token_type_ids, attention_mask,
                                 task_type_ids=task_type_ids)
        h = self.transform_norm(F.gelu(self.transform(seq), approximate=True))
        mlm = mlm_head(h, self.ernie.embeddings.word_embeddings.weight,
                       self.decoder_bias, masked_positions, "ernie_mlm_head",
                       self.mp_group)
        return mlm, self.sop_head(pooled)

    def loss(self, mlm_scores, sop_scores, masked_lm_labels, sop_labels,
             masked_lm_weights=None):
        return masked_lm_loss(mlm_scores, masked_lm_labels,
                              masked_lm_weights) + \
            F.cross_entropy(sop_scores, sop_labels)


def ernie_tiny(**kw) -> ErnieConfig:
    d = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=128,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    d.update(kw)
    return ErnieConfig(**d)


def ernie_base(**kw) -> ErnieConfig:
    return ErnieConfig(**kw)


def ernie_3_1p5b(**kw) -> ErnieConfig:
    """ERNIE-3.0 1.5B-class config (BASELINE config 5)."""
    d = dict(vocab_size=40000, hidden_size=2048, num_layers=24,
             num_heads=16, intermediate_size=8192,
             max_position_embeddings=2048)
    d.update(kw)
    return ErnieConfig(**d)
