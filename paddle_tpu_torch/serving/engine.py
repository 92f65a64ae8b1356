"""LLM serving engine: paged decode + continuous batching, PyTorch port.

Counterpart of ``paddle_tpu/serving/engine.py`` on one device (no
admin plane, drain, hot swap, resilience or mesh). Each
:meth:`ServingEngine.step`:

1. admits waiting requests into free slots (``Scheduler``), mapping the
   longest cached prefix copy-on-write when the prefix cache is on;
2. prefills every prefilling slot's next chunk in bucketed groups, each
   group one forward of ``[batch_bucket, len_bucket]`` token ids over
   the paged pools (padded rows writing only to the scratch page), and
   samples the first token of each request whose prefill is done;
3. stages speculative drafts (``serve_spec_k``), makes room for every
   decoding slot's next positions (recompute-preempting the newest
   requests when the pool runs dry) and runs ONE decode, or verify,
   forward over the full slot batch (other slots masked).

The JAX engine compiled one program per signature, donating the KV
pools to each; the port runs the same forwards eagerly and writes the
pools in place. On the card a fresh prefill's attention launches the
flash kernel, a context prefill's (a chunk continuation or a prefix-hit
tail, at ``pos > 0``) and a verify window's the biased flash kernel with
``causal=1`` over the right-aligned gathered context, and a decode
step the paged-decode kernel.

Throughput features, each behind its flag and read once, at
construction (``flag_scope`` around the constructor): the radix prefix
cache (``serve_prefix_cache``), chunked prefill
(``serve_prefill_chunk``) and n-gram speculative decoding
(``serve_spec_k``, ``serve_spec_ngram``). With all three off an engine
makes exactly the dispatches it made without them.

``ServingConfig.cache_dtype`` is ``"float32"`` or ``"bfloat16"``; a
bf16 engine (``inference.create_serving_engine`` under
``enable_tpu_bf16``) serves bf16 parameters over bf16, float32 or int8
pools, as the JAX engine does: the KV scatter casts k and v to the
pools' dtype, and the model casts q to it at the kernels and the
output back. Float32 parameters over bf16 pools are refused.

Multi-tenant serving: an engine built under ``flag_scope(
"serve_kv_quant", "int8")`` keeps int8 pools and decodes through the
quantized paged-decode kernel; ``ServingConfig.lora_adapters > 0``
builds a :class:`~.lora.LoRAManager` whose pools and per-row adapter ids
ride every prefill and decode view (the bgmv kernel, once per layer per
dispatch); ``tenant_quota`` caps the slots one tenant holds.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..core.device import DeviceLike, resolve_device
from ..core.flags import get_flag
from ..core.random import make_generator
from .detok import StreamingDetokenizer
from .kv_cache import (PagedCacheView, PagedKVCache, blocks_needed,
                       context_index)
from .lora import LoRAManager
from .prefix_cache import RadixPrefixCache
from .sampling import SamplingParams, sample_tokens, verify_draws
from .scheduler import (AdmissionGroup, BucketTable, Request, RequestState,
                        Scheduler)
from .spec_decode import propose_ngram

__all__ = ["ServingConfig", "ServingEngine"]


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


#: the pool dtypes the paged-decode and flash kernels take
_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ServingConfig:
    """Engine sizing + policy.

    ``max_context_len`` bounds prompt+generation per request;
    ``num_pages`` sizes the shared KV pool (default: every slot fully
    resident, so no preemption — shrink it to trade memory for
    recompute-preemptions). ``prefill_buckets``/``batch_buckets`` are the
    prefill shapes. ``cache_dtype`` is the pools' dtype, ``"float32"``
    or ``"bfloat16"`` (``FLAGS_serve_kv_quant=int8`` overrides it with
    int8 pools). ``lora_adapters > 0`` builds a LoRA manager with that
    many loadable adapters of rank ``lora_rank``; ``tenant_quota`` caps
    the slots one tenant may hold at a time (None: no cap)."""

    max_batch_slots: int = 8
    block_size: int = 16
    max_context_len: int = 512
    num_pages: Optional[int] = None
    prefill_buckets: Optional[Tuple[int, ...]] = None
    batch_buckets: Tuple[int, ...] = (1, 2, 4)
    max_queue: int = 1024
    seed: int = 0
    cache_dtype: str = "float32"
    detokenizer: Optional[StreamingDetokenizer] = None
    lora_adapters: int = 0
    lora_rank: int = 8
    tenant_quota: Optional[int] = None

    def resolve(self, model_max_positions: Optional[int]) -> None:
        if self.cache_dtype not in _CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype={self.cache_dtype!r}: the port's pools are "
                f"one of {sorted(_CACHE_DTYPES)}")
        if model_max_positions is not None:
            self.max_context_len = min(self.max_context_len,
                                       int(model_max_positions))
        if self.prefill_buckets is None:
            lo = min(max(self.block_size, 16), self.max_context_len)
            self.prefill_buckets = _pow2_buckets(lo, self.max_context_len)
        else:
            self.prefill_buckets = tuple(
                min(int(b), self.max_context_len)
                for b in self.prefill_buckets)
            if max(self.prefill_buckets) < self.max_context_len:
                # preemption re-prefills prompt+generated-so-far; the
                # table must cover the worst case
                self.prefill_buckets += (self.max_context_len,)
        self.batch_buckets = tuple(
            min(int(b), self.max_batch_slots) for b in self.batch_buckets)
        if self.num_pages is None:
            per_slot = blocks_needed(self.max_context_len, self.block_size)
            self.num_pages = 1 + self.max_batch_slots * per_slot


def _check_dtypes(params: Dict[str, torch.Tensor], cache_dtype: str):
    """Refuse a float32 parameter copy over bfloat16 pools. The model
    casts a bf16 copy's q to the pools' dtype at the decode kernels,
    exactly, and the output back (``GPTAttention._paged_attention``);
    but the bf16 decode kernel would round a float32 q to bf16, where
    the JAX kernel lifts q and the pages to f32, so the tokens would
    not be the JAX engine's."""
    if get_flag("serve_kv_quant") or cache_dtype != "bfloat16":
        return
    wide = {p.dtype for p in params.values() if p.is_floating_point()
            and torch.finfo(p.dtype).bits > 16}
    if wide:
        raise ValueError(
            f"parameters in {sorted(map(str, wide))} over "
            f"cache_dtype={cache_dtype!r} pools: the bf16 decode kernel "
            "would round q to bf16 (serve bf16 pools with "
            "param_dtype=torch.bfloat16, or keep cache_dtype='float32')")


class ServingEngine:
    """Serve a decoder-only model — ``forward(input_ids,
    caches=<PagedCacheView>, cache_pos=<[B] int32 positions>)`` returning
    logits ``[B, S, V]`` — with continuous batching on ``device`` (the
    card unless ``device="cpu"`` is passed)."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device: DeviceLike = None, clock=time.perf_counter, *,
                 param_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        # full-float32 products on the card, as the JAX package's
        # "highest" matmul precision (this is PyTorch's default; set
        # explicitly so a caller's global setting cannot change tokens)
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = getattr(model, "cfg", None)
        if cfg is None:
            raise ValueError("ServingEngine needs a model with a .cfg "
                             "(num_heads/head_dim/num_layers)")
        self.model = model.to(self.device).eval()
        # the weights served: a detached copy of the parameters and
        # buffers taken now, as the JAX engine's param_arrays /
        # buffer_arrays are (paddle_tpu/serving/engine.py:224-225), so a
        # layer that goes on training does not change this engine;
        # ``param_dtype`` casts the floating parameters as they are
        # copied (the layer keeps its own)
        self.params = {
            k: p.detach().to(dtype=param_dtype if param_dtype is not None
                             and p.is_floating_point() else p.dtype,
                             copy=True)
            for k, p in self.model.named_parameters()}
        self.buffers = {k: b.detach().clone()
                        for k, b in self.model.named_buffers()}
        # resolve() fills model-dependent defaults on a copy, so a
        # caller-owned config can be reused across engines
        self.config = dataclasses.replace(config) if config is not None \
            else ServingConfig()
        self.config.resolve(getattr(cfg, "max_position_embeddings", None))
        self.clock = clock
        c = self.config
        _check_dtypes(self.params, c.cache_dtype)
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.head_dim,
            num_pages=c.num_pages, block_size=c.block_size,
            max_slots=c.max_batch_slots,
            max_blocks_per_slot=blocks_needed(c.max_context_len,
                                              c.block_size),
            dtype=_CACHE_DTYPES[c.cache_dtype], device=self.device)
        self.buckets = BucketTable(c.prefill_buckets, c.batch_buckets)
        self.lora = None
        if c.lora_adapters > 0:
            # built before the scheduler, which keeps its references
            self.lora = LoRAManager(
                cfg.num_layers, cfg.hidden_size,
                3 * cfg.num_heads * cfg.head_dim,
                max_adapters=c.lora_adapters, rank=c.lora_rank,
                device=self.device)
        self.scheduler = Scheduler(self.cache, self.buckets,
                                   max_queue=c.max_queue, clock=clock,
                                   max_seq_len=c.max_context_len,
                                   tenant_quota=c.tenant_quota,
                                   lora=self.lora)
        # the throughput features, each read once here so an engine's
        # behaviour is fixed for its lifetime
        self._chunk = int(get_flag("serve_prefill_chunk") or 0)
        self._spec_k = int(get_flag("serve_spec_k") or 0)
        self._spec_ngram = max(1, int(get_flag("serve_spec_ngram") or 1))
        self.prefix_cache = None
        if bool(get_flag("serve_prefix_cache")):
            self.prefix_cache = RadixPrefixCache(self.cache)
            self.cache.prefix_cache = self.prefix_cache
        self._generator = make_generator(c.seed, self.device)
        # the accept/reject coin of stochastic speculative sampling: a
        # host stream of its own (the JAX engine's seed formula), apart
        # from the generator the sampled tokens draw from
        self._spec_rng = np.random.default_rng((int(c.seed) << 1) ^ 0x51EC)
        self._stats = {"prefill_dispatches": 0, "decode_dispatches": 0,
                       "decode_slot_steps": 0, "decode_batch_max": 0,
                       "tokens_generated": 0, "prefill_tokens": 0,
                       "prefill_chunks": 0, "context_prefill_dispatches": 0,
                       "verify_dispatches": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "spec_rolled_back": 0}
        self._lat: Dict[str, List[float]] = {
            "ttft": [], "tpot": [], "decode_step": []}
        self._t_first_work: Optional[float] = None
        self._t_last_token: Optional[float] = None

    @torch.no_grad()
    def warmup(self) -> int:
        """Build every kernel library (on the card), then run one
        forward of each dispatch signature this engine can issue before
        traffic arrives: the decode batch, every ``(batch, length)``
        prefill bucket and, with chunking or the prefix cache on, its
        context twin, and with ``serve_spec_k`` the verify window.
        Every row is padding (an all-scratch table row, the zero
        adapter), so only the scratch page is written and no engine
        counter moves (the kernels' launch counts do). Returns the
        number of kernels loaded (0 on the CPU)."""
        n_kernels = 0
        if self.device.type == "cuda":
            from ..ops import kernels
            kernels.build()
            n_kernels = len(kernels.KERNELS)
        B = self.config.max_batch_slots
        sigs = [(B, 1, False)]
        for nb, sp in self.buckets.signatures():
            sigs.append((nb, sp, False))
            if self._chunk > 0 or self.prefix_cache is not None:
                sigs.append((nb, sp, True))
        if self._spec_k > 0:
            sigs.append((B, self._spec_k + 1, True))
        for nb, sp, ctx in sigs:
            self._forward(np.zeros((nb, sp), np.int64), [None] * nb,
                          np.zeros((nb,), np.int32), context=ctx)
        return n_kernels

    # -- request surface ----------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        if request.adapter and (self.lora is None
                                or self.lora.row(request.adapter) is None):
            # the scheduler checks again at admission, for an unload
            # between now and then
            raise ValueError(
                f"adapter {request.adapter!r} is not loaded"
                + ("" if self.lora is not None
                   else " (engine has no LoRA manager; set "
                        "ServingConfig.lora_adapters)"))
        return self.scheduler.submit(request)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None) -> List[np.ndarray]:
        """Batch convenience: submit, drain, return full sequences
        (prompt + generated) per request, in submission order."""
        states = [self.submit(Request(
            p, max_new_tokens=max_new_tokens,
            sampling=sampling or SamplingParams(),
            eos_token_id=eos_token_id)) for p in prompts]
        self.run()
        return [np.concatenate([st.request.prompt,
                                np.asarray(st.generated, np.int32)])
                for st in states]

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive the scheduler until the queue and slots drain."""
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: admit, one prefill pass over every
        prefilling slot (fresh admissions and chunked prefills carried
        from earlier iterations), then one decode or verify dispatch
        over every decoding slot. Returns has_work."""
        sched = self.scheduler
        sched.plan_admissions()
        for group in self._plan_prefill_groups():
            self._run_prefill(group)
        if self._decodable():
            if self._spec_k > 0:
                # drafts staged before the capacity pass, so the verify
                # window's K/V writes land in real pages, never scratch
                self._stage_drafts()
            sched.ensure_decode_capacity()
            pairs = self._decodable()
            if pairs:
                if any(st.draft for _, st in pairs):
                    self._run_verify(pairs)
                else:
                    self._run_decode(pairs)
        return sched.has_work

    def _decodable(self) -> List[Tuple[int, RequestState]]:
        """Active slots that take a decode/verify row this iteration;
        chunked prefills still mid-prompt do not."""
        return [(slot, st) for slot, st in self.scheduler.active()
                if not st.prefilling]

    # -- dispatches ---------------------------------------------------------
    def _chunk_len(self, st: RequestState) -> int:
        remaining = st.prefill_len - st.prefill_pos
        return min(self._chunk, remaining) if self._chunk > 0 else remaining

    def _plan_prefill_groups(self) -> List[AdmissionGroup]:
        """Group every prefilling slot's next chunk into bucketed
        dispatches, keyed by (context, length bucket): a chunk at
        ``pos > 0`` runs the context path, ``pos == 0`` chunks the
        fresh one. Chunk length is ``min(serve_prefill_chunk,
        remaining)``. Within a key, admission order, up to the largest
        batch bucket a dispatch. With chunking and the prefix cache off
        every prefilling slot is a fresh admission with its whole
        effective prompt, the grouping of the engine without them."""
        by_key: Dict[Tuple[bool, int], List[RequestState]] = {}
        for _, st in self.scheduler.active():
            if not st.prefilling:
                continue
            key = (st.prefill_pos > 0,
                   self.buckets.len_bucket(self._chunk_len(st)))
            by_key.setdefault(key, []).append(st)
        groups: List[AdmissionGroup] = []
        mb = self.buckets.max_batch
        for key in sorted(by_key):
            sts = sorted(by_key[key], key=lambda s: (s.admitted_t,
                                                     s.request.request_id))
            for i in range(0, len(sts), mb):
                chunk = sts[i:i + mb]
                groups.append(AdmissionGroup(
                    key[1], self.buckets.batch_bucket(len(chunk)), chunk))
        return groups

    def _sampling_arrays(self, states: Sequence[Optional[RequestState]]):
        n = len(states)
        temps = np.ones((n,), np.float32)
        tks = np.zeros((n,), np.int64)
        tps = np.ones((n,), np.float32)
        for i, st in enumerate(states):
            if st is None:
                continue
            s = st.request.sampling
            temps[i], tks[i], tps[i] = s.temperature, s.top_k, s.top_p
        dev = self.device
        return (torch.from_numpy(temps).to(dev), torch.from_numpy(tks).to(dev),
                torch.from_numpy(tps).to(dev))

    def _sample(self, rows, states):
        """Next token and finiteness per row, on the host."""
        ok = torch.isfinite(rows).all(dim=-1)
        toks = sample_tokens(rows, *self._sampling_arrays(states),
                             generator=self._generator)
        return toks.cpu().numpy(), ok.cpu().numpy()

    def _forward(self, ids: np.ndarray, states, pos: np.ndarray,
                 context: bool = False):
        """One forward over the paged view; ``states`` has one entry per
        batch row, None for a padded row or a slot that takes no row (an
        all-scratch table row and the zero adapter). ``context`` selects
        the context-prefill path: rows start at ``pos`` and attend over
        every page-resident position before them."""
        dev = self.device
        c = self.cache
        lora = (None, None, None)
        if self.lora is not None:
            lora = (self.lora.a, self.lora.b, self.lora.rows_for(
                [None if st is None else st.request.adapter
                 for st in states]))
        table = c.table_rows([None if st is None else st.slot
                              for st in states])
        args = (c.k, c.v, torch.from_numpy(table).to(dev), c.k_scale,
                c.v_scale, *lora)
        view = PagedCacheView(*args, context_index(
            table, pos, ids.shape[1], c.block_size, dev) if context else None)
        return functional_call(
            self.model, (self.params, self.buffers),
            (torch.from_numpy(ids).to(dev),),
            {"caches": view, "cache_pos": torch.from_numpy(pos).to(dev)})

    def _run_prefill(self, group: AdmissionGroup) -> None:
        nb, sp = group.batch_bucket, group.len_bucket
        states: List[Optional[RequestState]] = list(group.states)
        states += [None] * (nb - len(states))
        ids = np.zeros((nb, sp), np.int64)
        lens = np.ones((nb,), np.int64)
        pos = np.zeros((nb,), np.int32)
        chunked = False
        # padded rows (None) get an all-scratch table row, so their K/V
        # writes never land in a live slot's pages
        for i, st in enumerate(states):
            if st is None:
                continue
            eff = st.effective_prompt()
            clen = self._chunk_len(st)
            chunked = chunked or clen < st.prefill_len - st.prefill_pos
            # copy-on-write: writes start at prefill_pos, never below
            # the shared prefix, so a shared page is read-only here
            if st.prefill_pos < (self.cache.slot_shared_blocks(st.slot)
                                 * self.cache.block_size):
                raise RuntimeError(
                    f"slot {st.slot} would write into its shared prefix")
            ids[i, :clen] = eff[st.prefill_pos:st.prefill_pos + clen]
            lens[i] = clen
            pos[i] = st.prefill_pos
        ctx = bool(pos.any())
        t0 = self.clock()
        if self._t_first_work is None:
            self._t_first_work = t0
        logits = self._forward(ids, states, pos, context=ctx)
        last = logits[torch.arange(nb, device=self.device),
                      torch.from_numpy(lens - 1).to(self.device)]
        toks, ok = self._sample(last, states)
        now = self.clock()
        st_ = self._stats
        st_["prefill_dispatches"] += 1
        st_["context_prefill_dispatches"] += int(ctx)
        if chunked or self._chunk > 0:
            st_["prefill_chunks"] += len(group.states)
        for i, st in enumerate(states):
            if st is None:
                continue
            st.prefill_pos += int(lens[i])
            st_["prefill_tokens"] += int(lens[i])
            if not ok[i]:
                self.scheduler.fail(st, "non-finite logits at prefill")
                continue
            if st.prefill_pos >= st.prefill_len:
                self._accept_token(st, int(toks[i]), now)

    def _stage_drafts(self) -> None:
        """Prompt-lookup drafting: up to ``k`` draft tokens per decoding
        slot from its own history, never past its token budget (the
        bonus token needs one). No draft anywhere: the iteration runs
        the plain decode dispatch."""
        proposed = 0
        for _, st in self._decodable():
            st.draft = []
            budget = min(self._spec_k, st.remaining_new_tokens() - 1)
            if budget <= 0:
                continue
            hist = np.concatenate([st.request.prompt,
                                   np.asarray(st.generated, np.int32)])
            st.draft = [int(t) for t in propose_ngram(
                hist, budget, max_ngram=self._spec_ngram)]
            proposed += len(st.draft)
        self._stats["spec_proposed"] += proposed

    def _run_verify(self, pairs) -> None:
        """ONE verify dispatch over the decoding slots: row 0 is each
        slot's plain decode step, rows 1..k score its staged draft. A
        greedy slot commits the accepted prefix plus one bonus token
        (token-exact with plain decode); a sampled slot accepts draft
        ``i`` with probability ``p_i(d_i)`` under its filtered
        distribution and, on a reject, commits the residual redraw and
        stops (the same marginal distribution as plain sampled decode).
        Pages holding only the rejected tail's K/V roll back by
        block-table truncation."""
        B = self.config.max_batch_slots
        S = self._spec_k + 1
        pos = np.zeros((B,), np.int32)
        ids = np.zeros((B, S), np.int64)
        per_slot: List[Optional[RequestState]] = [None] * B
        for slot, st in pairs:
            pos[slot] = st.seq_len - 1
            ids[slot, 0] = st.generated[-1]
            ids[slot, 1:1 + len(st.draft)] = st.draft
            per_slot[slot] = st
        t0 = self.clock()
        logits = self._forward(ids, per_slot, pos, context=True)  # [B,S,V]
        samp = self._sampling_arrays(per_slot)
        ok_rows = torch.isfinite(logits).all(dim=-1)
        tok0 = sample_tokens(logits[:, 0], *samp, generator=self._generator)
        greedy = torch.argmax(logits, dim=-1)
        sampled_any = any(st.request.sampling.temperature > 0.0
                          for _, st in pairs)
        if sampled_any:
            drafts = torch.from_numpy(ids[:, 1:]).to(self.device)
            p_draft, tok_full, tok_resid = (
                t.cpu().numpy() for t in verify_draws(
                    logits, drafts, *samp, generator=self._generator))
        tok0, greedy, ok_rows = (t.cpu().numpy()
                                 for t in (tok0, greedy, ok_rows))
        now = self.clock()
        st_ = self._stats
        st_["decode_dispatches"] += 1
        st_["verify_dispatches"] += 1
        st_["decode_slot_steps"] += len(pairs)
        st_["decode_batch_max"] = max(st_["decode_batch_max"], len(pairs))
        self._lat["decode_step"].append(now - t0)
        for slot, st in pairs:
            n = len(st.draft)
            if not ok_rows[slot, 0]:
                self.scheduler.fail(st, "non-finite logits at decode")
                continue
            sampled = st.request.sampling.temperature > 0.0
            if not sampled:
                # draft i survives iff it equals the previous row's
                # argmax and that row is finite
                n_acc = 0
                while n_acc < n and ok_rows[slot, n_acc] \
                        and st.draft[n_acc] == int(greedy[slot, n_acc]):
                    n_acc += 1
                commit = [int(tok0[slot])] + \
                    [int(greedy[slot, i]) for i in range(1, n_acc + 1)
                     if ok_rows[slot, i]]
            else:
                commit = []
                n_acc = 0
                for i in range(n):
                    if not ok_rows[slot, i]:
                        break
                    if self._spec_rng.random() < float(p_draft[slot, i]):
                        commit.append(int(st.draft[i]))
                        n_acc += 1
                    else:
                        commit.append(int(tok_resid[slot, i]))
                        break
                else:
                    if n == 0:
                        commit.append(int(tok0[slot]))
                    elif ok_rows[slot, n]:
                        commit.append(int(tok_full[slot, n]))
            committed = 0
            for t in commit:
                self._accept_token(st, t, now)
                committed += 1
                if st.terminal or st.is_done():
                    break
            acc = min(n_acc, committed) if sampled \
                else max(0, committed - 1)
            st_["spec_accepted"] += acc
            st_["spec_rolled_back"] += n - acc
            st.draft = []
            if not st.terminal:
                self.cache.truncate_slot(st.slot, st.seq_len)

    def _run_decode(self, pairs) -> None:
        B = self.config.max_batch_slots
        pos = np.zeros((B,), np.int32)
        tokens = np.zeros((B, 1), np.int64)
        per_slot: List[Optional[RequestState]] = [None] * B
        for slot, st in pairs:
            # the newest generated token is not yet in the cache: this
            # step writes its K/V at position seq_len-1 and attends over
            # everything up to and including it
            pos[slot] = st.seq_len - 1
            tokens[slot, 0] = st.generated[-1]
            per_slot[slot] = st
        t0 = self.clock()
        logits = self._forward(tokens, per_slot, pos)
        toks, ok = self._sample(logits[:, -1], per_slot)
        now = self.clock()
        st_ = self._stats
        st_["decode_dispatches"] += 1
        st_["decode_slot_steps"] += len(pairs)
        st_["decode_batch_max"] = max(st_["decode_batch_max"], len(pairs))
        self._lat["decode_step"].append(now - t0)
        for slot, st in pairs:
            if not ok[slot]:
                self.scheduler.fail(st, "non-finite logits at decode")
                continue
            self._accept_token(st, int(toks[slot]), now)

    def _accept_token(self, st: RequestState, token: int,
                      now: float) -> None:
        if st.first_token_t is None:
            st.first_token_t = now
            self._lat["ttft"].append(now - st.submitted_t)
        st.generated.append(token)
        self._stats["tokens_generated"] += 1
        self._t_last_token = now
        req = st.request
        try:
            if req.on_token is not None:
                text = None
                if self.config.detokenizer is not None:
                    text = self.config.detokenizer.piece(
                        token, is_first=len(st.generated) == 1)
                req.on_token(req, token, text)
            if req.stop is not None and req.stop(list(st.generated)):
                st.stop_hit = True
        except Exception as e:
            # a raising client callback or stop condition fails ONLY its
            # own request; the rest of the batch streams on
            self.scheduler.fail(st, f"callback error: {e!r}")
            return
        if st.is_done():
            self.scheduler.finish(st)
            n = len(st.generated)
            if n > 1:
                self._lat["tpot"].append((now - st.first_token_t) / (n - 1))

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        d = dict(self._stats)
        d.update(self.scheduler.stats)
        d["queue_depth"] = self.scheduler.queue_depth
        d["active_slots"] = len(self.scheduler.active())
        d["kv_pages_in_use"] = self.cache.allocator.pages_in_use
        if self.prefix_cache is not None:
            d["prefix_cache"] = dict(self.prefix_cache.stats,
                                     cached_pages=
                                     self.prefix_cache.cached_pages)
        if self.lora is not None:
            d["lora"] = {
                "loaded": self.lora.loaded(),
                "swaps": self.lora.swaps,
                "refcounts": {n: self.lora.refcount(n)
                              for n in self.lora.loaded()},
            }
        if self.scheduler.tenant_quota is not None:
            d["tenant_deferrals"] = dict(self.scheduler.tenant_deferrals)
        return d

    def metrics_summary(self) -> dict:
        """Host-clock latency/throughput summary (exact percentiles over
        the raw per-request samples)."""

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else None

        elapsed = None
        if self._t_first_work is not None and self._t_last_token is not None:
            elapsed = max(self._t_last_token - self._t_first_work, 1e-9)
        lat, s = self._lat, self._stats
        hit = (self.prefix_cache.stats["hit_tokens"]
               if self.prefix_cache is not None else 0)
        return {
            "requests_submitted": self.scheduler.stats["submitted"],
            "requests_completed": self.scheduler.stats["completed"],
            "requests_failed": self.scheduler.stats["failed"],
            "preemptions": self.scheduler.stats["preemptions"],
            "tokens_generated": s["tokens_generated"],
            "elapsed_s": elapsed,
            "tokens_per_sec": (s["tokens_generated"] / elapsed
                               if elapsed else None),
            "ttft_p50_s": pct(lat["ttft"], 50),
            "ttft_p99_s": pct(lat["ttft"], 99),
            "tpot_p50_s": pct(lat["tpot"], 50),
            "tpot_p99_s": pct(lat["tpot"], 99),
            "decode_step_p50_s": pct(lat["decode_step"], 50),
            "decode_step_p99_s": pct(lat["decode_step"], 99),
            "prefill_dispatches": s["prefill_dispatches"],
            "decode_dispatches": s["decode_dispatches"],
            "mean_decode_occupancy": (
                s["decode_slot_steps"] / s["decode_dispatches"]
                if s["decode_dispatches"] else None),
            "prefill_tokens": s["prefill_tokens"],
            "prefill_chunks": s["prefill_chunks"],
            "verify_dispatches": s["verify_dispatches"],
            # share of prompt positions served from cached pages instead
            # of prefill compute (None without a prefix cache)
            "prefix_hit_pct": (100.0 * hit / max(1, hit
                                                 + s["prefill_tokens"])
                               if self.prefix_cache is not None else None),
            "prefix_hit_tokens": hit,
            # committed draft tokens per proposed
            "spec_accept_pct": (100.0 * s["spec_accepted"]
                                / s["spec_proposed"]
                                if s["spec_proposed"] else None),
            "spec_proposed": s["spec_proposed"],
            "spec_accepted": s["spec_accepted"],
            "spec_rolled_back": s["spec_rolled_back"],
            "kv_bytes_per_token": self.cache.kv_bytes_per_token(),
            "quota_deferred": self.scheduler.stats["quota_deferred"],
        }

    def shutdown(self) -> None:
        """Drop every page the prefix cache holds (the only pages an
        idle engine keeps) and detach it."""
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
            self.cache.prefix_cache = None
            self.prefix_cache = None
