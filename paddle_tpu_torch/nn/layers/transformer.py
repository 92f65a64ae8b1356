"""Transformer encoder layers: counterpart of
``paddle_tpu/nn/layers/transformer.py``.

``MultiHeadAttention`` (:39-100) as self-attention with separate
``q_proj``/``k_proj``/``v_proj``/``out_proj`` and an additive mask that
broadcasts to ``[B, 1, 1, Sk]`` (the flash kernels' key bias on the
card), ``TransformerEncoderLayer`` (:114-155) as BERT and ERNIE build it
(``normalize_before=False``, ``activation="gelu"``, ``act_dropout=0``)
and ``TransformerEncoder`` (:161-210), whose layer loop casts each
layer's output back to the dtype of the stream that entered it, as the
JAX package's ``lax.scan`` over layers casts its carry
(``nn/scan.py:286``), and which runs each layer under
``fleet.utils.recompute`` in training when ``use_recompute`` is set (with
``recompute_policy``), as the JAX stack does. Pre-LN, other
activations, cross-attention, the decoder and the caches are not
ported: no model of the port uses them yet.

Tensor parallelism: ``distributed.spmd.apply_hybrid_specs`` stamps the
JAX Megatron specs by name (``q_proj``, ``k_proj``, ``v_proj`` and
``linear1`` column-parallel, ``out_proj`` and ``linear2`` row-parallel,
their biases replicated) and ``apply_param_shardings`` cuts each to the
rank's block. Told the mesh (``_on_mesh``), a layer whose projections
were cut runs Megatron's collectives over the mp group, through the
same autograd pair GPT's layers use (``distributed.mp_ops``): the
identity with an all-reduced gradient before the column products, the
all-reduce of the row products before their bias. Its heads are ``H/mp`` from head
``mp_rank * H/mp``, which the attention passes to the flash kernels as
the dropout mask's head base. A layer whose weights carry no mp block
(no specs stamped) stays replicated.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ...amp import cast_inputs
from ...distributed.mp_ops import (MPModule, copy_to_model_parallel,
                                   mp_group_of, reduce_from_model_parallel)
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm
from ..layer import Layer

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _mp_sharded(weight) -> bool:
    return any("mp" in axes
               for axes in getattr(weight, "_dist_layout", {}).values())


class _EncoderMPModule(MPModule):
    """An encoder layer that runs tensor-parallel only when its column
    projection (``_column``) was cut to an mp block."""

    _column = ""

    def _on_mesh(self, mesh) -> None:
        w = self.get_parameter(self._column)
        self.mp_group = mp_group_of(mesh) if _mp_sharded(w) else None
        self.mp_rank = mesh.axis_rank("mp") if self.mp_group else 0


def _row_parallel(x, layer: Linear, group):
    """``x @ W + b`` of a row-parallel ``layer``: the partial products
    all-reduced over ``group``, then the replicated bias."""
    x, w, b = cast_inputs("linear", x, layer.weight, layer.bias)
    return reduce_from_model_parallel(x @ w, group) + b


class MultiHeadAttention(_EncoderMPModule):
    """Self-attention over ``[B, S, E]``; ``attn_mask`` is an additive
    float mask."""

    _column = "q_proj.weight"

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device: Optional[torch.device] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, device)
        self.k_proj = Linear(embed_dim, embed_dim, device)
        self.v_proj = Linear(embed_dim, embed_dim, device)
        self.out_proj = Linear(embed_dim, embed_dim, device)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], -1, self.head_dim)

    def forward(self, x, attn_mask=None):
        group = self.mp_group
        xc = copy_to_model_parallel(x, group)
        q, k, v = (self._shape(proj(xc)) for proj in
                   (self.q_proj, self.k_proj, self.v_proj))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask, dropout_p=self.dropout,
            training=self.training, head_base=self.mp_rank * q.shape[2])
        out = out.reshape(out.shape[0], out.shape[1], -1)
        if group is None:
            return self.out_proj(out)
        return _row_parallel(out, self.out_proj, group)


class TransformerEncoderLayer(_EncoderMPModule):
    """Post-LN self-attention and FFN blocks:
    ``norm1(x + dropout1(attn(x)))``, then
    ``norm2(x + dropout2(linear2(gelu(linear1(x)))))`` with exact (erf)
    gelu, as ``getattr(F, "gelu")`` with its default ``approximate=False``
    in the JAX layer, and no dropout between the two linears."""

    _column = "linear1.weight"

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, attn_dropout: Optional[float] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            device)
        self.linear1 = Linear(d_model, dim_feedforward, device)
        self.linear2 = Linear(dim_feedforward, d_model, device)
        self.norm1 = LayerNorm(d_model, device)
        self.norm2 = LayerNorm(d_model, device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, src, src_mask=None):
        src = self.norm1(src + self.dropout1(self.self_attn(src, src_mask)))
        group = self.mp_group
        h = F.gelu(self.linear1(copy_to_model_parallel(src, group)))
        ffn = (self.linear2(h) if group is None
               else _row_parallel(h, self.linear2, group))
        return self.norm2(src + self.dropout2(ffn))


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` run in order (the model
    draws each copy's weights afresh)."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.use_recompute = False
        self.recompute_policy = None

    def forward(self, src, src_mask=None):
        out = src
        remat = self.use_recompute and self.training
        for layer in self.layers:
            if remat:
                from ...distributed.fleet.utils.recompute import recompute
                nxt = recompute(layer, out, src_mask,
                                policy=self.recompute_policy)
            else:
                nxt = layer(out, src_mask)
            # the scan carry keeps the stream's dtype across layers
            out = nxt.to(out.dtype)
        return out
