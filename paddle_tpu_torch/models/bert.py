"""BERT: bidirectional encoder and MLM head, PyTorch port.

Counterpart of ``paddle_tpu/models/bert.py``: word + position (+ token
type) embeddings with LayerNorm and dropout, a post-LN
``TransformerEncoder`` (exact-gelu FFN, no dropout between its linears),
a tanh pooler, and ``BertForMaskedLM``'s transform head (tanh-gelu,
LayerNorm) with the decoder tied to the word embeddings, which gathers
the masked positions before the vocab GEMM (:136-141). Parameter names
and layouts are the JAX package's, so a state dict copies across by name
(:mod:`.convert`).

A ``[B, S]`` 0/1 ``attention_mask`` becomes the additive key bias
``(1 - m) * -1e30`` of shape ``[B, 1, 1, S]`` (:104-110), which the
attention sends to the biased flash kernels on the card. Training mode
is the default, as for a JAX ``Layer``; each dropout draws its seed
words from the active ``core.random.dropout_generator`` (``TrainStep``
enters one, or pass ``generator=`` to ``forward``). Under
``amp.auto_cast`` the model casts at the JAX op names (``embedding``,
``linear``, ``scaled_dot_product_attention`` with the mask, ``mlm_head``),
so under O1 the whole residual stream is bf16.

Weights are drawn from ``seed`` by the JAX package's initializers: word
embeddings N(0, initializer_range), the other embeddings N(0, 1),
XavierUniform linears, zero biases, unit LayerNorm scales.

Tensor parallelism (BASELINE config 5's recipe): after
``distributed.spmd.apply_hybrid_specs`` stamps the JAX Megatron specs
and a mesh cuts the parameters (``TrainStep(mesh=...)`` or
``apply_param_shardings``), the encoder layers run column- and
row-parallel over the mp group (``nn/layers/transformer.py``), the word
table is vocab-parallel (each rank looks up its ``V/mp`` rows, the
blocks summed over mp), and the tied MLM head gives this rank's vocab
block of the scores, marked for the vocab-parallel loss
(``masked_lm_loss``). ``decoder_bias`` stays replicated (``P()``, as in
JAX): the head adds the rank's slice of it, and the slice's gradient is
all-gathered, so every mp rank holds the whole, equal gradient. Without
stamped specs the model stays replicated on any mesh.

Built with ``mesh=`` the model is made on the ``meta`` device, stamped
by ``apply_hybrid_specs``, and each layer is materialized, drawn in the
single-process order and cut to this rank's blocks one at a time
(:func:`init_weights`), so a rank never holds the whole f32 model: its
peak is its blocks plus the largest whole parameter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..amp import cast_inputs
from ..core.device import DeviceLike, resolve_device
from ..core.random import dropout_generator, make_generator
from ..distributed.meta_parallel.parallel_layers.mp_layers import (
    MPModule, copy_to_model_parallel, mark_mp_block, mp_group_of,
    scatter_to_model_parallel, vocab_parallel_embedding)
from ..nn import functional as F
from ..nn.chunked_ce import masked_lm_loss
from ..nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                         TransformerEncoder, TransformerEncoderLayer)
from ..ops.attention import NEG_INF
from ..nn.layer import Layer

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForMaskedLM",
           "bert_tiny", "bert_base", "bert_large"]


@dataclass
class BertConfig:
    vocab_size: int = 30528          # padded to a multiple of 64
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02


def encoder(cfg, device) -> TransformerEncoder:
    """The post-LN gelu encoder stack of BERT and ERNIE."""
    layer = TransformerEncoderLayer(
        cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
        dropout=cfg.hidden_dropout_prob,
        attn_dropout=cfg.attention_dropout_prob, device=device)
    return TransformerEncoder(layer, cfg.num_layers)


def additive_mask(attention_mask):
    """A ``[B, S]`` 0/1 mask as the additive float32 key bias
    ``[B, 1, 1, S]``; any other mask is passed on as it is."""
    if attention_mask is None or attention_mask.dim() != 2:
        return attention_mask
    return ((1.0 - attention_mask.float()) * NEG_INF)[:, None, None, :]


def mlm_head(hidden, weight, bias, masked_positions, op_name: str,
             mp_group=None):
    """Scores ``[B, M, V]`` of the tied decoder at the masked positions
    ``[B, M]`` (all ``S`` positions when None); over a vocab-sharded
    ``weight`` (``mp_group``) this rank's block ``[B, M, V/mp]`` with its
    slice of the replicated ``bias``, marked as a block."""
    hidden, weight, bias = cast_inputs(op_name, hidden, weight, bias)
    if masked_positions is not None:
        idx = masked_positions.long()[..., None]
        hidden = torch.gather(hidden, 1, idx.expand(-1, -1, hidden.shape[-1]))
    if mp_group is not None:
        hidden = copy_to_model_parallel(hidden, mp_group)
        bias = scatter_to_model_parallel(bias, mp_group)
    return mark_mp_block(torch.matmul(hidden, weight.t()) + bias, mp_group)


def _vocab_group(mesh, weight):
    """The mp group of a word table cut to a vocab block, else None."""
    sharded = any("mp" in axes for axes in
                  getattr(weight, "_dist_layout", {}).values())
    return mp_group_of(mesh) if sharded else None


def _materialize(m: nn.Module, device: torch.device) -> None:
    """Replace ``m``'s own ``meta`` parameters by tensors on ``device``
    (LayerNorm scales 1, everything else 0), keeping their specs."""
    for name, p in list(m.named_parameters(recurse=False)):
        if p.device.type != "meta":
            continue
        fill = 1.0 if isinstance(m, LayerNorm) and name == "weight" else 0.0
        q = nn.Parameter(torch.full(p.shape, fill, dtype=p.dtype,
                                    device=device))
        if hasattr(p, "spec"):
            q.spec = p.spec
        setattr(m, name, q)


def _cut(m: nn.Module, mesh) -> None:
    """Cut ``m``'s own parameters to this rank's blocks of their specs,
    as ``spmd.apply_param_shardings`` does."""
    from ..distributed.spmd import P, shard_layout, shard_tensor
    for p in m.parameters(recurse=False):
        layout = shard_layout(getattr(p, "spec", None) or P(), p.shape, mesh)
        p._full_shape = tuple(p.shape)
        p._dist_layout = layout
        if layout:
            p.data = shard_tensor(p.data, layout, mesh).contiguous().clone()


@torch.no_grad()
def init_weights(model: nn.Module, initializer_range: float,
                 generator: torch.Generator, mesh=None,
                 device: Optional[torch.device] = None) -> None:
    """Draw every Linear and Embedding of ``model`` by the JAX defaults,
    word embeddings N(0, initializer_range); biases are built as zeros
    and LayerNorms as (1, 0) already. With ``mesh``, ``model`` is on the
    ``meta`` device with its specs stamped: each module is materialized
    on ``device``, drawn (the same draws in the same order) and cut to
    this rank's blocks before the next."""
    for name, m in model.named_modules():
        if mesh is not None:
            _materialize(m, device)
        if isinstance(m, Linear):
            m.reset_parameters(generator)
        elif isinstance(m, Embedding):
            m.reset_parameters(generator, initializer_range
                               if name.endswith("word_embeddings") else 1.0)
        if mesh is not None:
            _cut(m, mesh)


def build(model: nn.Module, cfg, device: torch.device, seed: int,
          mesh=None) -> None:
    """Draw ``model``'s weights from ``seed``; with ``mesh`` (a model
    built on ``meta``) stamp the hybrid specs first and cut as it goes
    (:func:`init_weights`)."""
    if mesh is not None:
        from ..distributed.spmd import apply_hybrid_specs
        apply_hybrid_specs(model)
    init_weights(model, cfg.initializer_range, make_generator(seed, device),
                 mesh, device)


class BertEmbeddings(MPModule):
    """word + position (+ token-type) embeddings, LayerNorm and dropout;
    with ``task_type_vocab_size`` > 0 also ERNIE's task-type table, added
    to the sum when ``task_type_ids`` are given."""

    def __init__(self, cfg: BertConfig, device: torch.device,
                 task_type_vocab_size: int = 0):
        super().__init__()
        E = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, E, device)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, E,
                                             device)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, E,
                                               device)
        if task_type_vocab_size:
            self.task_type_embeddings = Embedding(task_type_vocab_size, E,
                                                  device)
        self.layer_norm = LayerNorm(E, device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def _on_mesh(self, mesh) -> None:
        self.mp_group = _vocab_group(mesh, self.word_embeddings.weight)
        self.mp_rank = mesh.axis_rank("mp") if self.mp_group else 0

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        w = self.word_embeddings.weight
        x = vocab_parallel_embedding(input_ids, w, self.mp_rank * w.shape[0],
                                     self.mp_group) + \
            self.position_embeddings(position_ids)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        if task_type_ids is not None:
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(Layer):
    """Embeddings + post-LN transformer encoder + tanh pooler; returns
    ``(seq [B, S, E], pooled [B, E])``."""

    def __init__(self, cfg: BertConfig, device: torch.device,
                 task_type_vocab_size: int = 0):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device, task_type_vocab_size)
        self.encoder = encoder(cfg, device)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, task_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        seq = self.encoder(x, additive_mask(attention_mask))
        return seq, F.tanh(self.pooler(seq[:, 0]))


class BertForMaskedLM(MPModule):
    """BERT + transform head + decoder tied to the word embeddings. Built
    on ``device`` (the card unless ``device="cpu"`` is passed) with
    weights drawn from ``seed``; with ``mesh=`` cut to this rank's
    blocks of the hybrid specs as it is built (the module's
    docstring)."""

    def __init__(self, cfg: BertConfig, device: DeviceLike = None,
                 seed: int = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        at = "meta" if mesh is not None else dev
        self.cfg = cfg
        self.bert = BertModel(cfg, at)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, at)
        self.transform_norm = LayerNorm(cfg.hidden_size, at)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     device=at))
        build(self, cfg, dev, seed, mesh)

    def _on_mesh(self, mesh) -> None:
        self.mp_group = _vocab_group(
            mesh, self.bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None,
                generator: Optional[torch.Generator] = None):
        """MLM scores ``[B, M, V]`` at ``masked_positions [B, M]``. In
        training mode with dropout, the seed words come from
        ``generator`` when given, else from the active
        ``dropout_generator``."""
        if generator is not None:
            with dropout_generator(generator):
                return self.forward(input_ids, token_type_ids,
                                    attention_mask, masked_positions)
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq), approximate=True))
        return mlm_head(h, self.bert.embeddings.word_embeddings.weight,
                        self.decoder_bias, masked_positions, "mlm_head",
                        self.mp_group)

    def loss(self, prediction_scores, masked_lm_labels,
             masked_lm_weights=None):
        """Mean NLL over the masked positions, weighted by
        ``masked_lm_weights [B, M]`` when given."""
        return masked_lm_loss(prediction_scores, masked_lm_labels,
                              masked_lm_weights)


def bert_tiny(**kw) -> BertConfig:
    d = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=128,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    d.update(kw)
    return BertConfig(**d)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    d = dict(hidden_size=1024, num_layers=24, num_heads=16,
             intermediate_size=4096)
    d.update(kw)
    return BertConfig(**d)
