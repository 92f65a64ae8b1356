"""Layers (counterpart of ``paddle_tpu.nn.layers``): the ones the GPT,
BERT and ERNIE models are built from."""

from .common import Dropout, Embedding, Linear
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
