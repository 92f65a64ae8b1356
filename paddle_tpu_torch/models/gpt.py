"""GPT: decoder-only language model (dense), PyTorch port.

Counterpart of ``paddle_tpu/models/gpt.py``: fused QKV attention, pre-LN
blocks, tied LM head, the no-cache forward (training and inference), the
paged-KV forward the serving engine drives, and
``GPTPretrainingCriterion``. Parameter names and layouts are the JAX
package's (``qkv_weight [E, 3, H, D]``, ``out_weight [H, D, E]``,
``w_in [E, FF]``, ``ln1.weight``, ...), so a state dict copies across by
name (:mod:`.convert`). There is no jit: PyTorch runs eagerly.

Training mode is the default, as for a JAX ``Layer`` (the serving engine
calls ``.eval()``). In training mode the embedding, the two residual
branches of every block and the attention probabilities are dropped, as
in the JAX model, each call drawing two seed words from the active
``core.random.dropout_generator`` (``TrainStep`` enters one, or pass
``generator=`` to ``GPTForPretraining.forward``).

Under ``amp.auto_cast`` the model casts at the JAX op names
(``embedding``, ``fused_qkv``, ``scaled_dot_product_attention``,
``attn_out``, ``linear``, ``lm_logits``), so its dtypes follow the JAX
model's: under O1 the stream starts in bf16, the MLP's ``y + b_out``
promotes to f32 (so ``dropout1`` runs on bf16 and ``dropout2`` on f32),
and each block's output is cast back to the dtype of the stream that
entered it, as the JAX package's ``lax.scan`` over layers casts its
carry (``nn/scan.py:286``).

Attention routes through ``ops.attention.sdpa_array`` (the flash
kernels on the card) for the causal no-cache and prefill paths and
through the paged-decode kernel for single-token decode steps, or its
quantized twin when the paged cache is int8 (``FLAGS_serve_kv_quant``).
A paged cache that carries LoRA pools adds each batch row's adapter
delta to the fused QKV projection through the bgmv kernel.

Float32 matmuls stay in full float32: ``torch.backends.cuda.matmul.
allow_tf32`` is False by default and the serving engine sets it so
explicitly, matching the JAX package's "highest" matmul precision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..amp import cast_inputs
from ..core.device import DeviceLike, resolve_device
from ..core.random import dropout_generator, make_generator
from ..nn import functional as F
from ..nn.chunked_ce import enabled_for, hard_nll
from ..nn.layers import Dropout, LayerNorm
from ..ops.attention import sdpa_array
from ..ops.kernels.bgmv import bgmv
from ..ops.kernels.paged_decode import (paged_decode_attention,
                                        paged_decode_attention_quant)
from ..serving.kv_cache import (PagedCacheView, PagedLayerCache,
                                write_pages, write_pages_quant)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTModel", "GPTForPretraining", "GPTPretrainingCriterion",
           "LayerNorm", "Dropout", "parallel_logits", "gpt_tiny",
           "gpt2_small", "gpt2_medium", "gpt2_large", "gpt2_xl"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: Optional[int] = None   # default 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _param(*shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class GPTAttention(nn.Module):
    """Causal self-attention with one fused QKV matmul."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        E, H, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.cfg = cfg
        self.num_heads, self.head_dim = H, D
        self.qkv_weight = _param(E, 3, H, D, device=device)
        self.qkv_bias = _param(3, H, D, device=device)
        self.out_weight = _param(H, D, E, device=device)
        self.out_bias = _param(E, device=device)

    def forward(self, x, cache: Optional[PagedLayerCache] = None, pos=None):
        B, S, E = x.shape
        H, D = self.num_heads, self.head_dim
        xc, w, b = cast_inputs("fused_qkv", x, self.qkv_weight,
                               self.qkv_bias)
        qkv = (xc @ w.reshape(E, 3 * H * D)).reshape(B, S, 3, H, D) + b
        if cache is not None and cache.lora_a is not None:
            # multi-tenant LoRA: every batch row's adapter delta, also
            # when every row is on the zero adapter (as in JAX)
            qkv = qkv + self._lora_delta(x, cache)
        q, k, v = qkv.unbind(2)                            # [B, S, H, D]
        if cache is not None:
            out = self._paged_attention(q, k, v, cache, pos)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.cfg.attention_dropout_prob,
                is_causal=True, training=self.training)
        out, w, b = cast_inputs("attn_out", out, self.out_weight,
                                self.out_bias)
        return out.reshape(B, S, H * D) @ w.reshape(H * D, E) + b

    def _lora_delta(self, x, cache: PagedLayerCache):
        """Each batch row's adapter delta ``[B, S, 3, H, D]`` for the
        fused QKV projection, in x's dtype: the ``[A, r, E]`` /
        ``[A, r, 3*H*D]`` pools read through ``cache.lora_ids`` by the
        bgmv kernel. Rows on adapter 0 get exactly 0.0."""
        d = bgmv(x.contiguous(), cache.lora_a, cache.lora_b,
                 cache.lora_ids)
        return d.reshape(d.shape[0], d.shape[1], 3, self.num_heads,
                         self.head_dim)

    def _paged_attention(self, q, k, v, cache: PagedLayerCache, pos):
        """Block-table K/V path. The chunk's K/V scatter into the pools
        (in place) at logical positions ``pos + 0..S-1``, quantized to
        int8 on the way when the cache has scale pools. Prefill (S > 1,
        fresh slots at pos 0) attends causally over its own chunk, as
        computed, never read back from the pages — the math of the
        full-context forward; decode (S == 1) reads the slot's pages
        through the block table (dequantizing int8 rows as it reads) and
        attends to positions ``<= pos``."""
        quant = cache.k_scale is not None
        if quant:
            write_pages_quant(cache.k_pages, cache.k_scale, k,
                              cache.block_table, pos)
            write_pages_quant(cache.v_pages, cache.v_scale, v,
                              cache.block_table, pos)
        else:
            write_pages(cache.k_pages, k, cache.block_table, pos)
            write_pages(cache.v_pages, v, cache.block_table, pos)
        if q.shape[1] > 1:
            return sdpa_array(q, k, v, is_causal=True)
        scale = 1.0 / math.sqrt(self.head_dim)
        q1 = q[:, 0].contiguous()
        if quant:
            o = paged_decode_attention_quant(
                q1, cache.k_pages, cache.k_scale, cache.v_pages,
                cache.v_scale, cache.block_table, pos, scale)
        else:
            o = paged_decode_attention(q1, cache.k_pages, cache.v_pages,
                                       cache.block_table, pos, scale)
        return o[:, None]


class GPTMLP(nn.Module):
    """FFN: in-proj, tanh-approximate gelu, out-proj."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        E, FF = cfg.hidden_size, cfg.ffn_size
        self.w_in = _param(E, FF, device=device)
        self.b_in = _param(FF, device=device)
        self.w_out = _param(FF, E, device=device)
        self.b_out = _param(E, device=device)

    def forward(self, x):
        h = F.gelu(F.linear(x, self.w_in, self.b_in), approximate=True)
        # bf16 + f32 promotes to f32 under O1, as in the JAX model
        return F.linear(h, self.w_out) + self.b_out


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: x + drop1(attn(ln1(x))); x + drop2(mlp(ln2(x)))."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, device)
        self.attn = GPTAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.hidden_size, device)
        self.mlp = GPTMLP(cfg, device)
        self.dropout1 = Dropout(cfg.hidden_dropout_prob)
        self.dropout2 = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, cache=None, pos=None):
        x = x + self.dropout1(self.attn(self.ln1(x), cache, pos))
        return x + self.dropout2(self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    """Embeddings + N decoder blocks + final LN. Returns hidden states."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=device)
        self.embedding_dropout = Dropout(cfg.hidden_dropout_prob)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(cfg, device) for _ in range(cfg.num_layers)])
        self.final_norm = LayerNorm(cfg.hidden_size, device)

    def forward(self, input_ids, position_ids=None,
                caches: Optional[PagedCacheView] = None, cache_pos=None):
        B, S = input_ids.shape
        if position_ids is None:
            start = (cache_pos[:, None].long() if caches is not None
                     else torch.zeros((1, 1), dtype=torch.long,
                                      device=input_ids.device))
            position_ids = start + torch.arange(S, device=input_ids.device)
        # padded prefill rows can run past the table: JAX clamps the
        # gather silently, PyTorch would fault, so clamp explicitly
        position_ids = position_ids.clamp(
            max=self.cfg.max_position_embeddings - 1)
        x = F.embedding(input_ids, self.word_embeddings.weight) + \
            F.embedding(position_ids, self.position_embeddings.weight)
        x = self.embedding_dropout(x)
        for i, blk in enumerate(self.layers):
            layer_cache = caches.layer(i) if caches is not None else None
            # the scan carry keeps the stream's dtype across layers
            x = blk(x, layer_cache, cache_pos).to(x.dtype)
        return self.final_norm(x)


def parallel_logits(hidden, embedding_weight):
    """LM head: ``hidden @ W_vocab.T`` against the tied embedding."""
    hidden, w = cast_inputs("lm_logits", hidden, embedding_weight)
    return torch.matmul(hidden, w.t())


class GPTForPretraining(nn.Module):
    """GPT with the tied LM head. Built on ``device`` (the card unless
    ``device="cpu"`` is passed) with weights drawn from ``seed`` by the
    JAX package's initializers: N(0, initializer_range) for matrices and
    embeddings, the residual-out projections scaled by
    ``1/sqrt(2*num_layers)``, zero biases, unit LayerNorm scales."""

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, dev)
        self._init_weights(make_generator(seed, dev))

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        # biases are built as zeros and LayerNorms as (1, 0) already
        std = self.cfg.initializer_range
        out_std = std / math.sqrt(2 * self.cfg.num_layers)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("out_weight", "w_out"):
                p.normal_(0.0, out_std, generator=g)
            elif leaf in ("qkv_weight", "w_in") or "embeddings" in name:
                p.normal_(0.0, std, generator=g)

    def forward(self, input_ids, position_ids=None,
                caches: Optional[PagedCacheView] = None, cache_pos=None,
                generator: Optional[torch.Generator] = None):
        """Logits ``[B, S, V]``. In training mode with dropout, the seed
        words come from ``generator`` when given, else from the active
        ``dropout_generator``."""
        if generator is not None:
            with dropout_generator(generator):
                return self.forward(input_ids, position_ids, caches,
                                    cache_pos)
        hidden = self.gpt(input_ids, position_ids, caches, cache_pos)
        return parallel_logits(hidden, self.gpt.word_embeddings.weight)


class GPTPretrainingCriterion(nn.Module):
    """Mean cross-entropy over the (non-masked) positions.

    Holds the single-device branch of the JAX ``ParallelCrossEntropy``
    (``mp_layers.py:157-168``): at a vocab of ``CHUNKED_CE_THRESHOLD``
    or more the streamed loss (``nn.chunked_ce.hard_nll``, the chunked-CE
    kernels on the card), below it the dense ``lse - tgt`` in float32
    with a detached max shift."""

    def forward(self, logits, labels, loss_mask=None):
        ids = labels.long()
        if ids.dim() == logits.dim():
            ids = ids.squeeze(-1)
        V = logits.shape[-1]
        if enabled_for(V):
            losses = hard_nll(logits, ids)
        else:
            lg32 = logits.float()
            z = lg32 - lg32.max(dim=-1, keepdim=True).values.detach()
            lse = torch.log(torch.sum(torch.exp(z), dim=-1))
            losses = lse - z.gather(-1, ids[..., None])[..., 0]
        if loss_mask is None:
            return losses.mean()
        m = loss_mask.float()
        return torch.sum(losses * m) / torch.clamp(torch.sum(m), min=1.0)


def gpt_tiny(**kw) -> GPTConfig:
    """Test-size config."""
    d = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_small(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
             max_position_embeddings=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_medium(**kw) -> GPTConfig:
    """GPT-2 345M."""
    d = dict(vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
             max_position_embeddings=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_large(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=1280, num_layers=36,
             num_heads=20, max_position_embeddings=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_xl(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=1600, num_layers=48,
             num_heads=25, max_position_embeddings=1024)
    d.update(kw)
    return GPTConfig(**d)
