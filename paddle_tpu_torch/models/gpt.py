"""GPT: decoder-only language model, dense or MoE, PyTorch port.

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
promotes to f32 (so ``dropout1`` runs on bf16 and ``dropout2`` on f32).
The JAX model runs a homogeneous stack (two or more blocks of one class)
as one ``lax.scan``, whose carry casts each block's output back to the
dtype of the stream that entered it (``nn/scan.py:286``), and a mixed
stack (dense and MoE blocks) as a per-layer loop that casts nothing; the
port casts exactly where the JAX model would scan, so under O1 a mixed
stack's stream is f32 from its first block on, as in JAX.

Mixture-of-Experts (``GPTConfig.moe_experts`` > 0): every
``moe_every``-th block is a :class:`GPTMoEDecoderLayer`, whose FFN is an
``incubate.moe.MoELayer`` (``layers.<i>.moe.gate.weight``,
``layers.<i>.moe.experts.w1`` ...; the dense blocks keep ``mlp.*``).
Without a cache the model collects the MoE blocks' router vectors
(``GPTModel.moe_layer_stats``) and their weighted aux and z losses
(``moe_loss()``, which a training loss adds to the CE); with a cache an
MoE block returns ``x`` as a dense one does, so ``generate`` and the
serving engine serve an MoE GPT unchanged. On a mesh with an ``ep``
axis the MoE layers run the expert-parallel program over it; on an mp
axis (with or without ep) every mp rank routes the same whole tokens
through the same replicated experts, as the JAX model composes MoE
with TP.

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
paths run on an mp group too (``ServingConfig.mesh``): the paged pools
hold the rank's heads (``spmd.SERVE_KV_SPEC``), and the paged, context
and static paths write and read those heads with the rank's ``H/mp``
queries, the out-projection's partial sums all-reduced as in training;
a LoRA ``b`` pool holds the rank's block of the fused QKV columns. The
paged forward returns the rank's vocab block of the logits (the engine
gathers them where it samples); a static-cache forward (``generate``,
whose buffers hold the rank's heads) returns them whole.

``use_recompute`` runs each block under ``fleet.utils.recompute`` in
training (``recompute_policy``: a JAX selective-remat policy name).
:class:`GPTForPretrainingPipe` refuses an MoE config, as the JAX class
does.

Sequence parallelism (``sequence_parallel``, the JAX config's flag,
with an ``sp`` mesh axis of more than one rank): the residual stream is
this rank's shard ``[B, S/sp, E]`` of every row (``TrainStep`` hands
each sp rank its slice of the ids, labels and mask), position ids are
the shard's global positions, attention runs as
``ops.ring_attention.ring_attention`` over the sp group (each visited
block through the flash kernels), and the hidden and attention dropouts
draw the single-process masks through the kernels' sequence bases
(``core.random.sequence_shard``). The criterion's mean is the global
one (its count summed over sp) and ``TrainStep`` sums the gradients
over sp. Where the JAX model pins the stream's layout for GSPMD
(``_seq_spec``), the port's rank holds the shard itself.

The pipeline models (BASELINE config 4): :class:`GPTForPretrainingPipe`
keeps the decoder blocks in a ``PipelineStageStack`` (``blocks.
stacked__*``, ``[L, ...]``, sharded over ``pp``) with the embeddings,
the final norm and the tied head replicated over ``pp`` (their
gradients summed over the pp group by ``TrainStep``). On a pp axis the
first stage embeds, the last applies the head; ``forward`` gives every
stage the last stage's logits (a pp broadcast), and ``pretraining_loss``
runs the resolved schedule with the head on the last stage a
microbatch at a time, returning the global masked mean on every stage.
:func:`build_gpt_pipe` is the same network as a ``PipelineParallel``
over ``gpt_pipeline_descs`` (the tied embedding a ``SharedLayerDesc``).
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
from ..core.random import (count_seed_draws, dropout_batch_base,
                           dropout_generator, make_generator,
                           next_seed_words, sequence_shard,
                           skip_seed_words)
from ..distributed.fleet.utils.recompute import recompute
from ..distributed.meta_parallel.parallel_layers.mp_layers import (
    MPModule, ParallelCrossEntropy, copy_to_model_parallel,
    mark_mp_block, reduce_from_model_parallel, vocab_parallel_embedding)
from ..distributed.mp_ops import gather_from_model_parallel
from ..distributed.spmd import P, count_over_data, loss_sum_groups
from ..incubate.moe.layer import (MoELayer, _publish_row,
                                  publish_router_stats, xavier_uniform_)
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm
from ..ops.attention import (NEG_INF, _sdpa_plain, context_attention,
                             sdpa_array)
from ..ops.kernels.bgmv import bgmv
from ..ops.kernels.paged_decode import (paged_decode_attention,
                                        paged_decode_attention_quant)
from ..ops.ring_attention import ring_attention
from ..serving.kv_cache import (PagedCacheView, PagedLayerCache,
                                gather_context, gather_context_quant,
                                write_pages, write_pages_quant)
from ..nn.layer import Layer

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTMoEDecoderLayer", "GPTModel", "GPTForPretraining",
           "GPTPretrainingCriterion", "LayerNorm", "Dropout",
           "parallel_logits", "gpt_tiny", "gpt2_small", "gpt2_medium",
           "gpt2_large", "gpt2_xl", "STATIC_BLOCK", "GPTForPretrainingPipe",
           "gpt_pipeline_descs", "build_gpt_pipe"]

#: positions a page when the paged-decode kernel reads a static cache:
#: ``generate`` allocates its buffers' length in whole pages
STATIC_BLOCK = 16

MP = "mp"
SP = "sp"


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
    #: shard the residual stream's sequence over the mesh's ``sp`` axis
    #: (ring attention over the sp group)
    sequence_parallel: bool = False
    #: Mixture-of-Experts: ``moe_experts`` > 0 swaps the FFN of every
    #: ``moe_every``-th decoder layer (layer i is MoE iff (i+1) %
    #: moe_every == 0) for an ``incubate.moe.MoELayer`` of ``moe_experts``
    #: stacked experts (hidden ``ffn_size``), top-``moe_top_k`` routing at
    #: ``moe_capacity_factor``; the router losses, weighted by
    #: ``moe_aux_weight`` / ``moe_z_weight``, are ``GPTModel.moe_loss()``
    moe_experts: int = 0
    moe_every: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2
    moe_z_weight: float = 1e-3

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def moe_layer_indices(self):
        """Decoder-layer indices that carry an MoE FFN."""
        if not self.moe_experts:
            return []
        k = max(1, int(self.moe_every))
        return [i for i in range(self.num_layers) if (i + 1) % k == 0]


def _sp_group_of(cfg: GPTConfig, mesh):
    """The sp group a sequence-parallel model runs over on ``mesh``, or
    None."""
    if not cfg.sequence_parallel or mesh.axis_size(SP) <= 1:
        return None
    return mesh.group(SP)


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

    sp_group = None

    def _on_mesh(self, mesh) -> None:
        super()._on_mesh(mesh)
        # this rank's heads: H/mp of them from head mp_rank * H/mp
        self.num_heads = self.qkv_weight.shape[2]
        self.sp_group = _sp_group_of(self.cfg, mesh)

    def seed_draws(self) -> int:
        """Seed-word pairs a no-cache call draws (the attention dropout)."""
        return int(self.training and self.cfg.attention_dropout_prob > 0)

    def forward(self, x, cache=None, pos=None):
        B, S, E = x.shape
        H, D = self.num_heads, self.head_dim
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
        elif self.sp_group is not None:
            out = self._ring_attention(q, k, v)
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

    def _ring_attention(self, q, k, v):
        """Causal attention of this rank's sequence shard over the sp
        group (``ops.ring_attention``), cast and dropped as
        ``F.scaled_dot_product_attention`` would the whole sequence."""
        q, k, v = cast_inputs("scaled_dot_product_attention", q, k, v)
        rate = self.cfg.attention_dropout_prob if self.training else 0.0
        words = next_seed_words() if rate > 0.0 else None
        return ring_attention(q, k, v, self.sp_group, causal=True,
                              dropout_rate=rate, seed_words=words,
                              batch_base=dropout_batch_base(),
                              head_base=self.mp_rank * self.num_heads)

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


class GPTDecoderLayer(Layer):
    """Pre-LN block: x + drop1(attn(ln1(x))); x + drop2(mlp(ln2(x)))."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, device)
        self.attn = GPTAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.hidden_size, device)
        self._build_ffn(cfg, device)
        self.dropout1 = Dropout(cfg.hidden_dropout_prob)
        self.dropout2 = Dropout(cfg.hidden_dropout_prob)

    def _build_ffn(self, cfg: GPTConfig, device: torch.device) -> None:
        self.mlp = GPTMLP(cfg, device)

    def _ffn(self, h):
        """The block's feed-forward half (``GPTMoEDecoderLayer`` swaps in
        the expert mixture)."""
        return self.mlp(h)

    def forward(self, x, cache=None, pos=None):
        x = x + self.dropout1(self.attn(self.ln1(x), cache, pos))
        return x + self.dropout2(self._ffn(self.ln2(x)))


class GPTMoEDecoderLayer(GPTDecoderLayer):
    """Pre-LN block whose FFN is a mixture of experts (``incubate.moe``,
    ``layers.<i>.moe.gate.weight``, ``layers.<i>.moe.experts.w1`` ...).
    Without a cache it returns ``(x, moe_vec)``, the layer's float32
    ``[aux, z, drop, entropy, balance, load_0..E-1]``; with a cache it
    returns ``x``, as the dense layer does, so every decode path is
    unchanged. It draws no seed words of its own: its dropouts are the
    dense block's."""

    def _build_ffn(self, cfg: GPTConfig, device: torch.device) -> None:
        self.moe = MoELayer(
            cfg.hidden_size, num_experts=cfg.moe_experts,
            d_hidden=cfg.ffn_size, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, device=device)

    def _ffn(self, h):
        return self.moe(h)

    def forward(self, x, cache=None, pos=None):
        out = super().forward(x, cache, pos)
        if cache is not None:
            return out
        return out, self.moe.moe_vec


def _embedding_out(module, input_ids, position_ids=None):
    """The word and position embeddings' sum and its dropout, for
    ``GPTModel`` and the pipeline's embedding stage; position ids start
    at 0 when none are given."""
    if position_ids is None:
        position_ids = torch.arange(input_ids.shape[1],
                                    device=input_ids.device)[None]
    # padded prefill rows can run past the table: JAX clamps the
    # gather silently, PyTorch would fault, so clamp explicitly
    position_ids = position_ids.clamp(
        max=module.cfg.max_position_embeddings - 1)
    wte = module.word_embeddings.weight
    x = vocab_parallel_embedding(input_ids, wte, module.mp_rank *
                                 wte.shape[0], module.mp_group) + \
        F.embedding(position_ids, module.position_embeddings.weight)
    return module.embedding_dropout(x)


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
        moe_idx = set(cfg.moe_layer_indices())
        if cfg.moe_experts and not moe_idx:
            raise ValueError(
                f"moe_experts={cfg.moe_experts} but moe_every="
                f"{cfg.moe_every} places no MoE layer in a "
                f"{cfg.num_layers}-layer stack (layer i is MoE iff "
                "(i+1) % moe_every == 0)")
        self.layers = nn.ModuleList(
            [GPTMoEDecoderLayer(cfg, device) if i in moe_idx else
             GPTDecoderLayer(cfg, device) for i in range(cfg.num_layers)])
        for i in sorted(moe_idx):
            self.layers[i].moe._label = f"layer{i}"
        self.final_norm = LayerNorm(cfg.hidden_size, device)
        self._moe_vecs = None
        self._moe_loss = None

    sp_group = None

    def _on_mesh(self, mesh) -> None:
        super()._on_mesh(mesh)
        self.sp_group = _sp_group_of(self.cfg, mesh)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_pos=None):
        """Hidden states ``[B, S, E]``; with a list of
        :class:`GPTAttention.StaticCache` (written in place) and its
        integer write offset ``cache_pos``, ``(hidden, caches)``. Under
        sequence parallelism ``input_ids`` is the rank's shard of every
        row and the result the shard's hidden states."""
        if self.sp_group is not None and caches is None:
            S = input_ids.shape[1]
            s0 = self.sp_group.rank * S
            if position_ids is None:
                position_ids = s0 + torch.arange(
                    S, device=input_ids.device)[None]
            with sequence_shard(s0, self.sp_group.nranks * S):
                return self._forward(input_ids, position_ids, None, None)
        return self._forward(input_ids, position_ids, caches, cache_pos)

    def _forward(self, input_ids, position_ids, caches, cache_pos):
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
        if position_ids is None and caches is not None:
            start = torch.full((1, 1), cache_pos, dtype=torch.long,
                               device=input_ids.device) if static \
                else cache_pos[:, None].long()
            position_ids = start + torch.arange(S, device=input_ids.device)
        x = _embedding_out(self, input_ids, position_ids)
        remat = self.cfg.use_recompute and self.training and caches is None
        # the JAX model runs a homogeneous stack as one lax.scan (no
        # cache, or a paged one), whose carry keeps the stream's dtype
        # across layers; a mixed stack (MoE every other layer) and a
        # static cache run its per-layer loop, which casts nothing, so
        # under O1 the stream stays in the dtype the first promoting
        # block returns
        scan = not static and _scans(self.layers)
        vecs = []
        for i, blk in enumerate(self.layers):
            if remat:
                out = recompute(blk, x, policy=self.cfg.recompute_policy)
            else:
                layer_cache = (caches[i] if static else caches.layer(i)
                               if caches is not None else None)
                out = blk(x, layer_cache, cache_pos)
            if isinstance(blk, GPTMoEDecoderLayer) and caches is None:
                out, vec = out
                vecs.append(vec)
            x = out.to(x.dtype) if scan else out
        if caches is None:
            self._moe_vecs = torch.stack(vecs) if vecs else None
            if self.cfg.moe_experts:
                self._reduce_moe_loss()
        x = self.final_norm(x)
        return (x, list(caches)) if static else x

    # -- the MoE side channel ----------------------------------------------
    def _reduce_moe_loss(self) -> None:
        """The weighted router losses of the last no-cache forward: aux
        and z summed over the MoE layers (a value of that forward's
        graph: add it to the loss it ran for)."""
        v = self._moe_vecs
        if v is None:
            self._moe_loss = None
            return
        w_a = float(self.cfg.moe_aux_weight)
        w_z = float(self.cfg.moe_z_weight)
        self._moe_loss = (w_a * v[:, 0].sum()
                          + w_z * v[:, 1].sum()).to(torch.float32)

    def moe_loss(self):
        """The weighted MoE router loss (aux + z) of the last forward, or
        None for a dense config: ``crit(logits, labels) +
        model.gpt.moe_loss()``."""
        return self._moe_loss

    def moe_layer_stats(self):
        """The MoE layers' router vectors ``[L_moe, 5+E]`` of the last
        no-cache forward (rows in ``cfg.moe_layer_indices()`` order,
        columns ``[aux, z, drop, entropy, balance, load_0..E-1]``), or
        None."""
        return self._moe_vecs

    def publish_moe_telemetry(self, registry=None) -> int:
        """Publish the per-layer router gauges of the last forward into
        the monitor registry (``tools/monitor_report.py --moe`` renders
        them); returns the number of layers published."""
        vecs = self._moe_vecs
        if vecs is None:
            return publish_router_stats(self, registry)
        arr = vecs.detach().double().cpu().numpy()
        E = self.cfg.moe_experts
        for row, i in zip(arr, self.cfg.moe_layer_indices()):
            _publish_row(row[2:], f"layer{i}", E, registry)
        return arr.shape[0]


def _scans(layers) -> bool:
    """Whether the JAX model would run ``layers`` as one ``lax.scan``
    (``nn/scan.py::can_scan_layers``): two or more blocks of one class
    (the same parameter shapes, by construction)."""
    return len(layers) >= 2 and len({type(b) for b in layers}) == 1


def parallel_logits(hidden, embedding_weight, mp_group=None):
    """LM head: ``hidden @ W_vocab.T`` against the tied embedding; over
    a vocab-sharded table (``mp_group``) the rank's logits block, the
    hidden states' gradient all-reduced over the group."""
    hidden = copy_to_model_parallel(hidden, mp_group)
    hidden, w = cast_inputs("lm_logits", hidden, embedding_weight)
    return mark_mp_block(torch.matmul(hidden, w.t()), mp_group)


class GPTForPretraining(Layer):
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

    def _init_weights(self, g: torch.Generator) -> None:
        _init_gpt_weights(self, self.cfg, g)

    def moe_loss(self):
        """The weighted MoE router loss of the last forward
        (``GPTModel.moe_loss``), or None for a dense config."""
        return self.gpt.moe_loss()

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
            group = self.gpt.mp_group
            return gather_from_model_parallel(parallel_logits(
                hidden, self.gpt.word_embeddings.weight, group),
                group), caches
        return parallel_logits(out, self.gpt.word_embeddings.weight,
                               self.gpt.mp_group)

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        """Decode continuations over a static KV cache
        (:func:`..generation.generate`)."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        **kwargs)


@torch.no_grad()
def _init_gpt_weights(module: nn.Module, cfg: GPTConfig,
                      g: torch.Generator) -> None:
    """The JAX initializers in parameter order: N(0, initializer_range)
    for matrices and embeddings, the residual-out projections scaled by
    ``1/sqrt(2*num_layers)``; biases stay zero and LayerNorms (1, 0).
    A stacked name (``blocks.stacked__mlp__w_out``) initializes like its
    template's. An MoE layer's gate and stacked experts take the JAX
    ``XavierUniform`` default over their whole shapes."""
    std = cfg.initializer_range
    out_std = std / math.sqrt(2 * cfg.num_layers)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1].rsplit("__", 1)[-1]
        if leaf in ("out_weight", "w_out"):
            p.normal_(0.0, out_std, generator=g)
        elif leaf in ("qkv_weight", "w_in") or "embeddings" in name:
            p.normal_(0.0, std, generator=g)
        elif leaf in ("w1", "w2") or name.endswith("moe.gate.weight"):
            xavier_uniform_(p, g)


class GPTPretrainingCriterion(Layer):
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
        if loss_mask is None and loss_sum_groups():
            # a sequence shard: the mean over every rank's positions
            loss_mask = torch.ones_like(losses)
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


# ---------------------------------------------------------------------------
# pipeline-parallel GPT (BASELINE config 4: GPT-2 345M over pp x mp)
# ---------------------------------------------------------------------------

class GPTForPretrainingPipe(MPModule):
    """GPT with the decoder stack as a pipeline over the ``pp`` axis
    (the JAX ``GPTForPretrainingPipe``, ``models/gpt.py:918``): the
    blocks in a ``PipelineStageStack`` (``blocks.stacked__<name>``
    ``[L, ...]``), the embeddings, final norm and tied head outside it,
    replicated over ``pp`` and sharded over ``mp`` as in
    ``GPTForPretraining``. Without a pp axis the stack runs its layers
    in turn (the same parameters, the same math). Built on ``device``
    with weights from ``seed`` (the JAX initializers)."""

    def __init__(self, cfg: GPTConfig,
                 num_microbatches: Optional[int] = None,
                 schedule: Optional[str] = None, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        from ..distributed.meta_parallel.spmd_pipeline import \
            PipelineStageStack
        if cfg.moe_experts:
            raise NotImplementedError(
                "GPTForPretrainingPipe does not support MoE configs (the "
                "pipeline stage stack builds dense decoder layers); use "
                "GPTForPretraining, as the JAX package says")
        dev = resolve_device(device)
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=dev)
        self.word_embeddings.weight.spec = P(MP, None)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=dev)
        self.embedding_dropout = Dropout(cfg.hidden_dropout_prob)
        self.blocks = PipelineStageStack(
            lambda: GPTDecoderLayer(cfg, dev), cfg.num_layers,
            num_microbatches=num_microbatches, schedule=schedule)
        self.final_norm = LayerNorm(cfg.hidden_size, dev)
        self.ce = ParallelCrossEntropy()
        _init_gpt_weights(self, cfg, make_generator(seed, dev))

    def _pipelined(self) -> bool:
        return self.blocks.pp_degree() > 1

    def _embed(self, input_ids, position_ids=None):
        return _embedding_out(self, input_ids, position_ids)

    def _stage_input(self, input_ids, position_ids):
        """The stack's input: the embeddings on the first stage (or
        without a pp axis); on a later stage a ``meta`` tensor of its
        shape and dtype, the embedding dropout's draws skipped."""
        if not self._pipelined() or self.blocks.stage_id() == 0:
            return self._embed(input_ids, position_ids)
        skip_seed_words(count_seed_draws(self.embedding_dropout))
        w = self.position_embeddings.weight
        (probe,) = cast_inputs("embedding", w.new_empty(0))
        B, S = input_ids.shape
        return torch.empty((B, S, self.cfg.hidden_size), dtype=probe.dtype,
                           device="meta")

    def forward(self, input_ids, position_ids=None,
                generator: Optional[torch.Generator] = None):
        """Logits ``[B, S, V]`` (this rank's vocab block on an mp
        group), on every stage."""
        if generator is not None:
            with dropout_generator(generator):
                return self.forward(input_ids, position_ids)
        x = self._stage_input(input_ids, position_ids)
        y = self.blocks(x)
        wte = self.word_embeddings.weight
        if not self._pipelined():
            return parallel_logits(self.final_norm(y), wte, self.mp_group)
        from ..distributed.meta_parallel.spmd_pipeline import \
            last_stage_output
        stack = self.blocks
        last = stack.stage_id() == stack.pp_degree() - 1
        logits = None
        if last:
            logits = parallel_logits(self.final_norm(y), wte, self.mp_group)
        a, b = cast_inputs("lm_logits", x.new_empty(0, device="cpu"),
                           wte.new_empty(0, device="cpu"))
        shape = tuple(x.shape[:2]) + (wte.shape[0],)
        group = stack._pp_group
        out = last_stage_output(logits, logits if last else y, shape,
                                torch.promote_types(a.dtype, b.dtype),
                                group, group.ranks[-1])
        return mark_mp_block(out, self.mp_group)

    def _head_apply(self):
        """The loss head over explicit leaves: final LayerNorm, the tied
        vocab-parallel logits, the masked CE -> (loss_sum, mask_sum),
        float32 (JAX ``_head_apply``, ``:982``)."""
        from torch.func import functional_call
        norm, ce, group = self.final_norm, self.ce, self.mp_group

        def head_apply(leaves, y, lab, msk):
            h = functional_call(norm, {"weight": leaves[0],
                                       "bias": leaves[1]}, (y,))
            logits = parallel_logits(h, leaves[2], group)
            losses = ce(logits, lab)[..., 0].float()
            m = msk.float()
            return torch.sum(losses * m), torch.sum(m)
        return head_apply

    def pretraining_loss(self, input_ids, labels, loss_mask=None,
                         position_ids=None):
        """Embeddings -> ``PipelineStageStack.train_loss`` (the resolved
        schedule; the head on the last stage a microbatch at a time) ->
        the masked mean over the global batch: the sum of the
        microbatches' ``(loss_sum, mask_sum)``, the mask counted over the
        data ranks, divided once. The same scalar on every stage."""
        x = self._stage_input(input_ids, position_ids)
        if loss_mask is None:
            loss_mask = torch.ones(tuple(labels.shape), dtype=torch.float32,
                                   device=labels.device)
        head = [self.final_norm.weight, self.final_norm.bias,
                self.word_embeddings.weight]
        ls, dn = self.blocks.train_loss(x, self._head_apply(), head,
                                        [labels, loss_mask])
        cnt, n = count_over_data(dn.detach())
        if n > 1:
            ls = ls * n
        return ls / torch.clamp(cnt, min=1.0)


class _GPTEmbeddingStage(MPModule):
    """Embedding front of the pipeline: ids -> hidden states (its word
    table is the tied head's, through a ``SharedLayerDesc``)."""

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=dev)
        self.word_embeddings.weight.spec = P(MP, None)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=dev)
        self.embedding_dropout = Dropout(cfg.hidden_dropout_prob)
        _init_gpt_weights(self, cfg, make_generator(seed, dev))

    def forward(self, input_ids):
        return _embedding_out(self, input_ids, None)


def gpt_pipeline_descs(cfg: GPTConfig, device: DeviceLike = None,
                       seed: int = 0):
    """Layer descriptions for ``PipelineLayer``: embedding | N blocks |
    final norm | tied head (the embedding table shared between the
    first and last stage)."""
    from ..distributed.meta_parallel.parallel_layers.pp_layers import (
        LayerDesc, SharedLayerDesc)
    dev = resolve_device(device)

    def embed_fwd(shared, ids):
        return shared(ids)

    def head_fwd(shared, hidden):
        # tied LM head: project onto the first stage's embedding table
        return parallel_logits(hidden, shared.word_embeddings.weight,
                               shared.mp_group)

    descs = [SharedLayerDesc("gpt_embed", _GPTEmbeddingStage,
                             forward_func=embed_fwd, cfg=cfg, device=dev,
                             seed=seed)]
    descs += [LayerDesc(GPTDecoderLayer, cfg, dev)
              for _ in range(cfg.num_layers)]
    descs.append(LayerDesc(LayerNorm, cfg.hidden_size, dev))
    descs.append(SharedLayerDesc("gpt_embed", _GPTEmbeddingStage,
                                 forward_func=head_fwd, cfg=cfg, device=dev,
                                 seed=seed))
    return descs


def build_gpt_pipe(cfg: GPTConfig, num_stages: int, accumulate_steps: int = 1,
                   seg_method: str = "uniform", device: DeviceLike = None,
                   seed: int = 0):
    """GPT as a ``PipelineParallel`` engine over ``gpt_pipeline_descs``
    (pp outer, the mp layers inside each desc). Under a fleet topology
    of ``num_stages`` pp stages each rank builds its own stage; the
    decoder blocks draw their weights from ``seed`` and the shared
    embedding is its first stage's."""
    from ..distributed.meta_parallel.parallel_layers.pp_layers import (
        PipelineLayer)
    from ..distributed.meta_parallel.pipeline_parallel import (
        PipelineParallel)
    crit = GPTPretrainingCriterion()

    def loss_fn(logits, labels):
        return crit(logits, labels)

    pl_layer = PipelineLayer(gpt_pipeline_descs(cfg, device, seed),
                             num_stages=num_stages, loss_fn=loss_fn,
                             seg_method=seg_method)
    g = make_generator(seed + 1, resolve_device(device))
    for name, sub in pl_layer.named_children():
        for m in sub.children():
            if isinstance(m, GPTDecoderLayer):
                _init_gpt_weights(m, cfg, g)
    return PipelineParallel(pl_layer, accumulate_steps=accumulate_steps)


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
