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
kernels on the card) for the causal no-cache and prefill paths, through
``ops.attention.context_attention`` (the biased flash forward, causal,
over the right-aligned gathered context) for context prefills (a
paged view with its ``context`` set: a chunk continuation, a prefix-hit tail, a speculative verify window) and
through the paged-decode kernel for single-token decode steps, or its
quantized twin when the paged cache is int8 (``FLAGS_serve_kv_quant``).
The static cache of ``models.generation.generate``
(:class:`GPTAttention.StaticCache`, ``[B, L, H, D]`` float32 buffers
written in place at ``cache_pos``) attends on the card through the
flash forward for a chunk at position 0 and through the paged-decode
kernel for a one-token step, the contiguous buffer read as pages of
``STATIC_BLOCK`` positions; on the CPU through the plain composition
with the JAX model's mask.
With a bfloat16 parameter copy (``inference.create_serving_engine``
under ``enable_tpu_bf16``) every activation is bf16, as in the JAX
model under its bf16 snapshot: the embeddings' sum, the residual
stream, the QKV, attention and MLP outputs and the logits; layer norm
computes its statistics in f32 and returns bf16.
A paged cache that carries LoRA pools adds each batch row's adapter
delta to the fused QKV projection through the bgmv kernel.

Float32 matmuls stay in full float32: ``torch.backends.cuda.matmul.
allow_tf32`` is False by default and the serving engine sets it so
explicitly, matching the JAX package's "highest" matmul precision.

Tensor parallelism: every parameter carries the JAX model's ``.spec``
(``qkv_weight`` P(None, None, 'mp', None), ``w_in`` P(None, 'mp'), the
word embeddings P('mp', None), ...). ``distributed.spmd.
apply_param_shardings`` cuts each to the rank's block (``H/mp`` heads,
``FF/mp`` of the MLP, ``V/mp`` rows of the tied table) and tells the
modules their mp group (``_on_mesh``); they then run Megatron's
collectives (``meta_parallel.parallel_layers.mp_layers``): an identity
with an all-reduced gradient before the QKV, ``w_in`` and LM-head
products, an all-reduce after ``out_weight`` and ``w_out`` and after
the vocab-masked lookup. The logits are the rank's vocab block, which
``GPTPretrainingCriterion`` takes through the vocab-parallel loss.
Attention passes its first head and the step's batch base to the flash
kernels, so each rank draws its slice of the single-process dropout
masks. A model on no mesh is exactly the model above. The serving
paths (paged and static caches) take no mp group.

``use_recompute`` runs each block under ``fleet.utils.recompute`` in
training (``recompute_policy``: a JAX selective-remat policy name).
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..amp import cast_inputs
from ..core.device import DeviceLike, resolve_device
from ..core.random import dropout_generator, make_generator
from ..distributed.fleet.utils.recompute import recompute
from ..distributed.meta_parallel.parallel_layers.mp_layers import (
    MPModule, ParallelCrossEntropy, copy_to_model_parallel,
    mark_mp_block, reduce_from_model_parallel, vocab_parallel_embedding)
from ..distributed.spmd import P, count_over_data
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm
from ..ops.attention import (NEG_INF, _sdpa_plain, context_attention,
                             sdpa_array)
from ..ops.kernels.bgmv import bgmv
from ..ops.kernels.paged_decode import (paged_decode_attention,
                                        paged_decode_attention_quant)
from ..serving.kv_cache import (PagedCacheView, PagedLayerCache,
                                gather_context, gather_context_quant,
                                write_pages, write_pages_quant)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTModel", "GPTForPretraining", "GPTPretrainingCriterion",
           "LayerNorm", "Dropout", "parallel_logits", "gpt_tiny",
           "gpt2_small", "gpt2_medium", "gpt2_large", "gpt2_xl",
           "STATIC_BLOCK"]

#: positions a page when the paged-decode kernel reads a static cache:
#: ``generate`` allocates its buffers' length in whole pages
STATIC_BLOCK = 16

MP = "mp"


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
    use_recompute: bool = False
    #: selective-remat policy name for use_recompute (see
    #: fleet.utils.recompute.resolve_checkpoint_policy); None = full
    #: recompute
    recompute_policy: Optional[str] = None

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _param(*shape, device, spec=P()):
    p = nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))
    p.spec = spec
    return p



class GPTAttention(MPModule):
    """Causal self-attention with one fused QKV matmul."""

    #: fixed-size K/V buffers ``[B, L, H, D]`` of ``models.generation``,
    #: as in the JAX model: a chunk writes its K/V at ``pos`` and row
    #: ``i`` attends to slots ``j <= pos + i``
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        E, H, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.cfg = cfg
        self.num_heads, self.head_dim = H, D
        self.qkv_weight = _param(E, 3, H, D, device=device,
                                 spec=P(None, None, MP, None))
        self.qkv_bias = _param(3, H, D, device=device, spec=P(None, MP, None))
        self.out_weight = _param(H, D, E, device=device,
                                 spec=P(MP, None, None))
        self.out_bias = _param(E, device=device)

    def _on_mesh(self, mesh) -> None:
        super()._on_mesh(mesh)
        # this rank's heads: H/mp of them from head mp_rank * H/mp
        self.num_heads = self.qkv_weight.shape[2]

    def forward(self, x, cache=None, pos=None):
        B, S, E = x.shape
        H, D = self.num_heads, self.head_dim
        if self.mp_group is not None and cache is not None:
            raise NotImplementedError(
                "a model laid on an mp group attends without a cache only "
                "(tensor-parallel serving is not ported yet)")
        x = copy_to_model_parallel(x, self.mp_group)
        xc, w, b = cast_inputs("fused_qkv", x, self.qkv_weight,
                               self.qkv_bias)
        qkv = (xc @ w.reshape(E, 3 * H * D)).reshape(B, S, 3, H, D) + b
        if isinstance(cache, PagedLayerCache) and cache.lora_a is not None:
            # multi-tenant LoRA: every batch row's adapter delta, also
            # when every row is on the zero adapter (as in JAX)
            qkv = qkv + self._lora_delta(x, cache)
        q, k, v = qkv.unbind(2)                            # [B, S, H, D]
        if isinstance(cache, GPTAttention.StaticCache):
            out = self._static_attention(q, k, v, cache, pos)
        elif cache is not None:
            out = self._paged_attention(q, k, v, cache, pos)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.cfg.attention_dropout_prob,
                is_causal=True, training=self.training,
                head_base=self.mp_rank * H)
        out, w, b = cast_inputs("attn_out", out, self.out_weight,
                                self.out_bias)
        return reduce_from_model_parallel(
            out.reshape(B, S, H * D) @ w.reshape(H * D, E),
            self.mp_group) + b

    def _lora_delta(self, x, cache: PagedLayerCache):
        """Each batch row's adapter delta ``[B, S, 3, H, D]`` for the
        fused QKV projection, in x's dtype: the ``[A, r, E]`` /
        ``[A, r, 3*H*D]`` pools read through ``cache.lora_ids`` by the
        bgmv kernel. Rows on adapter 0 get exactly 0.0."""
        d = bgmv(x.contiguous(), cache.lora_a, cache.lora_b,
                 cache.lora_ids)
        return d.reshape(d.shape[0], d.shape[1], 3, self.num_heads,
                         self.head_dim)

    def _static_attention(self, q, k, v, cache, pos: int):
        """Static-cache attention (``generate``). The chunk's K/V are
        written into the buffers in place at ``pos .. pos + S - 1``; row
        ``i`` attends to slots ``j <= pos + i``, as the JAX model's
        ``[1, 1, S, L]`` mask of 0 and -1e30 says. On the CPU: that mask
        and the plain composition over the whole buffer. On the card
        (slots past ``pos + i`` add exactly zero there): a chunk at
        ``pos == 0`` attends causally over its own K/V through the flash
        forward, and a one-token step reads the buffer as ``L /
        STATIC_BLOCK`` pages a row through the paged-decode kernel. Any
        other chunk raises: no kernel takes it."""
        kb, vb = cache
        B, S, H, D = q.shape
        L = kb.shape[1]
        if pos + S > L:
            raise ValueError(f"static cache of {L} positions cannot take "
                             f"{S} more at position {pos}")
        kb[:, pos:pos + S] = k.to(kb.dtype)
        vb[:, pos:pos + S] = v.to(vb.dtype)
        # the kernels and the plain einsums take one dtype: the JAX
        # composition's promotion of q over the f32 buffers
        ct = torch.promote_types(q.dtype, kb.dtype)
        if q.device.type == "cpu":
            rows = pos + torch.arange(S)[:, None]
            mask = torch.where(torch.arange(L)[None, :] <= rows, 0.0,
                               NEG_INF)[None, None]
            return _sdpa_plain(q.to(ct), kb.to(ct), vb.to(ct),
                               mask).to(q.dtype)
        if pos == 0:
            return sdpa_array(q.to(ct), k.to(ct), v.to(ct),
                              is_causal=True).to(q.dtype)
        if S == 1 and L % STATIC_BLOCK == 0:
            n = L // STATIC_BLOCK
            table = torch.arange(B * n, dtype=torch.int32,
                                 device=q.device).view(B, n)
            pos_b = torch.full((B,), pos, dtype=torch.int32,
                               device=q.device)
            pages = (B * n, STATIC_BLOCK, H, D)
            o = paged_decode_attention(
                q[:, 0].to(ct).contiguous(), kb.view(pages), vb.view(pages),
                table, pos_b, 1.0 / math.sqrt(D))
            return o.to(q.dtype)[:, None]
        raise NotImplementedError(
            f"no kernel for a static-cache chunk of {S} tokens at position "
            f"{pos} over {L} slots (the card takes a chunk at position 0, "
            f"or one token over a buffer of whole {STATIC_BLOCK}-position "
            "pages)")

    def _paged_attention(self, q, k, v, cache: PagedLayerCache, pos):
        """Block-table K/V path. The chunk's K/V scatter into the pools
        (in place) at logical positions ``pos + 0..S-1``, quantized to
        int8 on the way when the cache has scale pools. Prefill (S > 1,
        fresh slots at pos 0) attends causally over its own chunk, as
        computed, never read back from the pages — the math of the
        full-context forward. A context prefill (S > 1 under a
        cache whose ``context`` is set) gathers each row's positions
        ``0 .. pos + S - 1`` back out of the pages, just written chunk
        included (dequantized from int8), into the right-aligned context
        of ``cache.context`` and attends causally with its key bias, so
        row ``i`` sees positions ``<= pos + i``. Decode (S == 1) reads
        the slot's pages through the block table (dequantizing int8 rows
        as it reads) and attends to positions ``<= pos``."""
        quant = cache.k_scale is not None
        if quant:
            write_pages_quant(cache.k_pages, cache.k_scale, k,
                              cache.block_table, pos)
            write_pages_quant(cache.v_pages, cache.v_scale, v,
                              cache.block_table, pos)
        else:
            write_pages(cache.k_pages, k, cache.block_table, pos)
            write_pages(cache.v_pages, v, cache.block_table, pos)
        ctx = cache.context
        if q.shape[1] > 1 and ctx is not None:
            if quant:
                kc = gather_context_quant(cache.k_pages, cache.k_scale, ctx)
                vc = gather_context_quant(cache.v_pages, cache.v_scale, ctx)
            else:
                kc = gather_context(cache.k_pages, ctx)
                vc = gather_context(cache.v_pages, ctx)
            # the flash kernel takes one dtype: the promotion of the
            # JAX composition's einsums (bf16 q over f32 context: f32)
            ct = torch.promote_types(q.dtype, kc.dtype)
            return context_attention(q.to(ct), kc.to(ct), vc.to(ct),
                                     ctx.bias).to(q.dtype)
        if q.shape[1] > 1:
            return sdpa_array(q, k, v, is_causal=True)
        scale = 1.0 / math.sqrt(self.head_dim)
        # the decode kernels read q in the pools' dtype (float32 over
        # int8 pools) and the output returns in q's, as the JAX kernel
        # lifts q and the pages to f32 and writes q's dtype
        q1 = q[:, 0].to(torch.float32 if quant else cache.k_pages.dtype)
        q1 = q1.contiguous()
        if quant:
            o = paged_decode_attention_quant(
                q1, cache.k_pages, cache.k_scale, cache.v_pages,
                cache.v_scale, cache.block_table, pos, scale)
        else:
            o = paged_decode_attention(q1, cache.k_pages, cache.v_pages,
                                       cache.block_table, pos, scale)
        return o.to(q.dtype)[:, None]


class GPTMLP(MPModule):
    """FFN: in-proj, tanh-approximate gelu, out-proj."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        E, FF = cfg.hidden_size, cfg.ffn_size
        self.w_in = _param(E, FF, device=device, spec=P(None, MP))
        self.b_in = _param(FF, device=device, spec=P(MP))
        self.w_out = _param(FF, E, device=device, spec=P(MP, None))
        self.b_out = _param(E, device=device)

    def forward(self, x):
        x = copy_to_model_parallel(x, self.mp_group)
        h = F.gelu(F.linear(x, self.w_in, self.b_in), approximate=True)
        # bf16 + f32 promotes to f32 under O1, as in the JAX model
        return reduce_from_model_parallel(F.linear(h, self.w_out),
                                          self.mp_group) + self.b_out


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


class GPTModel(MPModule):
    """Embeddings + N decoder blocks + final LN. Returns hidden states."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=device)
        self.word_embeddings.weight.spec = P(MP, None)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=device)
        self.embedding_dropout = Dropout(cfg.hidden_dropout_prob)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(cfg, device) for _ in range(cfg.num_layers)])
        self.final_norm = LayerNorm(cfg.hidden_size, device)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_pos=None):
        """Hidden states ``[B, S, E]``; with a list of
        :class:`GPTAttention.StaticCache` (written in place) and its
        integer write offset ``cache_pos``, ``(hidden, caches)``."""
        B, S = input_ids.shape
        # a list of StaticCache, or the serving engine's paged view
        static = caches is not None and not isinstance(caches,
                                                       PagedCacheView)
        if static:
            if cache_pos is None:
                raise ValueError(
                    "StaticCache decoding needs cache_pos (the write offset "
                    "into the fixed-size KV buffers); models/generation.py "
                    "threads it automatically")
            cache_pos = int(cache_pos)
        if position_ids is None:
            if static:
                start = torch.full((1, 1), cache_pos, dtype=torch.long,
                                   device=input_ids.device)
            elif caches is not None:
                start = cache_pos[:, None].long()
            else:
                start = torch.zeros((1, 1), dtype=torch.long,
                                    device=input_ids.device)
            position_ids = start + torch.arange(S, device=input_ids.device)
        # padded prefill rows can run past the table: JAX clamps the
        # gather silently, PyTorch would fault, so clamp explicitly
        position_ids = position_ids.clamp(
            max=self.cfg.max_position_embeddings - 1)
        wte = self.word_embeddings.weight
        x = vocab_parallel_embedding(input_ids, wte, self.mp_rank *
                                     wte.shape[0], self.mp_group) + \
            F.embedding(position_ids, self.position_embeddings.weight)
        x = self.embedding_dropout(x)
        remat = self.cfg.use_recompute and self.training and caches is None
        for i, blk in enumerate(self.layers):
            if remat:
                x = recompute(blk, x, policy=self.cfg.recompute_policy
                              ).to(x.dtype)
                continue
            layer_cache = (caches[i] if static else caches.layer(i)
                           if caches is not None else None)
            # the scan carry keeps the stream's dtype across layers
            x = blk(x, layer_cache, cache_pos).to(x.dtype)
        x = self.final_norm(x)
        return (x, list(caches)) if static else x


def parallel_logits(hidden, embedding_weight, mp_group=None):
    """LM head: ``hidden @ W_vocab.T`` against the tied embedding; over
    a vocab-sharded table (``mp_group``) the rank's logits block, the
    hidden states' gradient all-reduced over the group."""
    hidden = copy_to_model_parallel(hidden, mp_group)
    hidden, w = cast_inputs("lm_logits", hidden, embedding_weight)
    return mark_mp_block(torch.matmul(hidden, w.t()), mp_group)


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

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_pos=None, generator: Optional[torch.Generator] = None):
        """Logits ``[B, S, V]``, or ``(logits, caches)`` over a list of
        :class:`GPTAttention.StaticCache`. In training mode with
        dropout, the seed words come from ``generator`` when given, else
        from the active ``dropout_generator``."""
        if generator is not None:
            with dropout_generator(generator):
                return self.forward(input_ids, position_ids, caches,
                                    cache_pos)
        out = self.gpt(input_ids, position_ids, caches, cache_pos)
        if isinstance(out, tuple):
            hidden, caches = out
            return parallel_logits(hidden,
                                   self.gpt.word_embeddings.weight), caches
        return parallel_logits(out, self.gpt.word_embeddings.weight,
                               self.gpt.mp_group)

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        """Decode continuations over a static KV cache
        (:func:`..generation.generate`)."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        **kwargs)


class GPTPretrainingCriterion(nn.Module):
    """Mean cross-entropy over the (non-masked) positions, through
    ``ParallelCrossEntropy`` as in the JAX model: on one device (or mp =
    1) at a vocab of ``CHUNKED_CE_THRESHOLD`` or more the streamed loss
    (``nn.chunked_ce.hard_nll``, the chunked-CE kernels on the card),
    below it the dense ``lse - tgt`` in float32 with a detached max
    shift; over the logits block of a model laid on an mp group the
    vocab-parallel loss. Inside a data-parallel ``TrainStep`` the
    ``loss_mask`` is counted over every data rank, so the step's loss
    is the global batch's masked mean, as in the JAX mesh step."""

    def __init__(self):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, logits, labels, loss_mask=None):
        losses = self.ce(logits, labels)[..., 0]
        if loss_mask is None:
            return losses.mean()
        m = loss_mask.float()
        # in a data-parallel step the mask is counted over every rank,
        # so the ranks' average is the global batch's masked mean
        cnt, n = count_over_data(torch.sum(m))
        num = torch.sum(losses * m)
        if n > 1:
            num = num * n
        return num / torch.clamp(cnt, min=1.0)


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
