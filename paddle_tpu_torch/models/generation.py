"""Autoregressive generation over a static KV cache, PyTorch port.

Counterpart of ``paddle_tpu/models/generation.py``: greedy or sampled
(temperature, top-k, top-p) decoding of a batch of fixed-length prompts
into preallocated ``[B, L, H, D]`` float32 K/V buffers
(``GPTAttention.StaticCache``), with eos padding. One prefill forward
writes the prompt's K/V at position 0; then ``max_new_tokens - 1``
one-token forwards, each writing its K/V at the next position.

The JAX package compiles the prefill and one ``lax.scan`` over the
decode steps into two cached programs per signature (``_gen_compiled``
on the model). PyTorch runs eagerly, so the port has nothing to compile
or cache: the steps are a Python loop, and a greedy run reads nothing
back to the host until the end. On the card the prefill's attention is
the flash forward and each step's the paged-decode kernel over the
buffers read as pages (``GPTAttention._static_attention``).

The draws come from a ``torch.Generator`` seeded with ``seed``; JAX's
threefry keys give other numbers, so a sampled run is reproducible per
seed in each package but not across them. :func:`filter_logits` is the
JAX ``_sample``'s temperature, top-k and top-p filter (the serving
sampler's, with one setting for the batch), so its masks can be compared
with the JAX package's on the same logits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.random import make_generator
from ..serving.sampling import filtered_logits
from .gpt import STATIC_BLOCK, GPTAttention

__all__ = ["generate", "filter_logits"]


def filter_logits(logits, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Float32 ``[B, V]`` logits divided by the temperature, every one
    below the ``top_k``-th largest and every one outside the smallest
    sorted prefix whose probability reaches ``top_p`` set to -1e30: the
    serving sampler's filter with one setting for every row. A ``top_p``
    of 1 or more filters nothing, as in the JAX ``_sample`` (the f32
    cumulative sum may reach 1.0 before the last token)."""
    B = logits.shape[0]
    dev = logits.device
    return filtered_logits(
        logits,
        torch.full((B,), float(temperature), dtype=torch.float32,
                   device=dev),
        torch.full((B,), int(top_k), dtype=torch.long, device=dev),
        torch.full((B,), float(top_p) if top_p < 1.0 else float("inf"),
                   dtype=torch.float32, device=dev))


def _sample(logits, decode_strategy: str, temperature: float,
            top_k: int, top_p: float, generator: Optional[torch.Generator]):
    """The next token ``[B]`` int64 from ``[B, V]`` logits."""
    if decode_strategy == "greedy_search":
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int = 32,
             decode_strategy: str = "sampling", temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None,
             pad_token_id: int = 0, seed: int = 0):
    """Generate continuations for a batch of prompts.

    ``model``: a GPT whose forward takes ``(input_ids,
    caches=<list of StaticCache>, cache_pos=<int>)`` and returns
    ``(logits, caches)``; it runs in eval mode on its own device.
    ``input_ids``: ``[B, S0]`` token ids (array, list or tensor).
    Returns int32 ids ``[B, S0 + max_new_tokens]`` on the model's
    device; positions after an eos are ``pad_token_id``."""
    if decode_strategy not in ("greedy_search", "sampling"):
        raise ValueError(
            f"unknown decode_strategy {decode_strategy!r}: use "
            "'greedy_search' or 'sampling' (beam search lives in "
            "paddle_tpu_torch.nn.BeamSearchDecoder + dynamic_decode)")
    dev = next(iter(model.parameters())).device
    prompt = torch.as_tensor(np.asarray(
        input_ids.cpu() if torch.is_tensor(input_ids) else input_ids),
        dtype=torch.long).to(dev)
    B, S0 = prompt.shape
    max_new_tokens = int(max_new_tokens)
    L = S0 + max_new_tokens
    cfg = model.cfg
    if L > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt ({S0}) + max_new_tokens ({max_new_tokens}) = {L} "
            f"exceeds max_position_embeddings="
            f"{cfg.max_position_embeddings}; positions past the table "
            "would silently clamp")
    D = cfg.head_dim
    # a model on an mp group attends with its rank's heads
    attn = next((m for m in model.modules()
                 if isinstance(m, GPTAttention)), None)
    H = cfg.num_heads if attn is None else attn.num_heads
    # whole pages, so a decode step can read the buffers as a page pool
    # (slots past the written positions are never visible)
    Lb = -(-L // STATIC_BLOCK) * STATIC_BLOCK
    caches = [GPTAttention.StaticCache(
        torch.zeros((B, Lb, H, D), dtype=torch.float32, device=dev),
        torch.zeros((B, Lb, H, D), dtype=torch.float32, device=dev))
        for _ in range(cfg.num_layers)]
    gen = make_generator(seed, dev) if decode_strategy == "sampling" \
        else None

    def pick(logits):
        return _sample(logits, decode_strategy, temperature, top_k, top_p,
                       gen)

    was_training = model.training
    model.eval()
    try:
        logits, caches = model(prompt, caches=caches, cache_pos=0)
        tok = pick(logits[:, -1, :])
        toks = [tok]
        finished = (tok == eos_token_id) if eos_token_id is not None \
            else None
        for t in range(max_new_tokens - 1):
            logits, caches = model(tok[:, None], caches=caches,
                                   cache_pos=S0 + t)
            tok = pick(logits[:, -1, :])
            if finished is not None:
                tok = torch.where(finished, pad_token_id, tok)
                finished = finished | (tok == eos_token_id)
            toks.append(tok)
    finally:
        if was_training:
            model.train()
    return torch.cat([prompt, torch.stack(toks, dim=1)],
                     dim=1).to(torch.int32)
