"""LLM serving engine: paged decode + continuous batching, PyTorch port.

Counterpart of ``paddle_tpu/serving/engine.py`` (single device, no
admin plane, drain, hot swap, speculative/prefix/chunked prefill or
mesh). Each :meth:`ServingEngine.step`:

1. admits waiting requests into free slots (``Scheduler``);
2. prefills them in bucketed groups — each group one forward of
   ``[batch_bucket, len_bucket]`` token ids over the paged pools, padded
   rows writing only to the scratch page — and samples each request's
   first token;
3. runs ONE decode forward over the full slot batch (inactive slots
   masked), after making room for every slot's next position and
   recompute-preempting the newest requests when the pool runs dry.

The JAX engine compiled one program per prefill bucket and one for
decode, donating the KV pools to each; the port runs the same forwards
eagerly and writes the pools in place. The attention of every prefill
launches the flash kernel and every decode step the paged-decode
kernel when the engine lives on the card.

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
from ..core.random import make_generator
from .detok import StreamingDetokenizer
from .kv_cache import PagedCacheView, PagedKVCache, blocks_needed
from .lora import LoRAManager
from .sampling import SamplingParams, sample_tokens
from .scheduler import (AdmissionGroup, BucketTable, Request, RequestState,
                        Scheduler)

__all__ = ["ServingConfig", "ServingEngine"]


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


@dataclass
class ServingConfig:
    """Engine sizing + policy.

    ``max_context_len`` bounds prompt+generation per request;
    ``num_pages`` sizes the shared KV pool (default: every slot fully
    resident, so no preemption — shrink it to trade memory for
    recompute-preemptions). ``prefill_buckets``/``batch_buckets`` are the
    prefill shapes. ``lora_adapters > 0`` builds a LoRA manager with that
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
        if self.cache_dtype != "float32":
            raise ValueError(
                f"cache_dtype={self.cache_dtype!r}: the port serves "
                "float32 pools (the JAX engine's default); other pool "
                "dtypes are not ported yet")
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


class ServingEngine:
    """Serve a decoder-only model — ``forward(input_ids,
    caches=<PagedCacheView>, cache_pos=<[B] int32 positions>)`` returning
    logits ``[B, S, V]`` — with continuous batching on ``device`` (the
    card unless ``device="cpu"`` is passed)."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device: DeviceLike = None, clock=time.perf_counter):
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
        # layer that goes on training does not change this engine
        self.params = {k: p.detach().clone()
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
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.head_dim,
            num_pages=c.num_pages, block_size=c.block_size,
            max_slots=c.max_batch_slots,
            max_blocks_per_slot=blocks_needed(c.max_context_len,
                                              c.block_size),
            dtype=getattr(torch, c.cache_dtype), device=self.device)
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
        self._generator = make_generator(c.seed, self.device)
        self._stats = {"prefill_dispatches": 0, "decode_dispatches": 0,
                       "decode_slot_steps": 0, "decode_batch_max": 0,
                       "tokens_generated": 0, "prefill_tokens": 0}
        self._lat: Dict[str, List[float]] = {
            "ttft": [], "tpot": [], "decode_step": []}
        self._t_first_work: Optional[float] = None
        self._t_last_token: Optional[float] = None

    def warmup(self) -> int:
        """Build every kernel library before traffic arrives (on the
        card; nothing to build on the CPU). Returns the number of kernels
        now loaded."""
        if self.device.type != "cuda":
            return 0
        from ..ops import kernels
        kernels.build()
        return len(kernels.KERNELS)

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
        """One scheduler iteration: admit + prefill, then one decode
        dispatch over every active slot. Returns has_work."""
        sched = self.scheduler
        admitted = sched.plan_admissions()
        for group in self._plan_prefill_groups(admitted):
            self._run_prefill(group)
        if sched.active():
            sched.ensure_decode_capacity()
            pairs = sched.active()
            if pairs:
                self._run_decode(pairs)
        return sched.has_work

    # -- dispatches ---------------------------------------------------------
    def _plan_prefill_groups(self, admitted: Sequence[RequestState]) \
            -> List[AdmissionGroup]:
        """Group freshly admitted requests by length bucket, up to the
        largest batch bucket per dispatch, in admission order within a
        bucket."""
        by_len: Dict[int, List[RequestState]] = {}
        for st in admitted:
            by_len.setdefault(self.buckets.len_bucket(st.prefill_len),
                              []).append(st)
        groups: List[AdmissionGroup] = []
        mb = self.buckets.max_batch
        for lb in sorted(by_len):
            sts = sorted(by_len[lb], key=lambda s: (s.admitted_t,
                                                    s.request.request_id))
            for i in range(0, len(sts), mb):
                chunk = sts[i:i + mb]
                groups.append(AdmissionGroup(
                    lb, self.buckets.batch_bucket(len(chunk)), chunk))
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

    def _forward(self, ids: np.ndarray, states, pos: np.ndarray):
        """One forward over the paged view; ``states`` has one entry per
        batch row, None for a padded prefill row or an empty slot (an
        all-scratch table row and the zero adapter)."""
        dev = self.device
        c = self.cache
        lora = (None, None, None)
        if self.lora is not None:
            lora = (self.lora.a, self.lora.b, self.lora.rows_for(
                [None if st is None else st.request.adapter
                 for st in states]))
        view = PagedCacheView(
            c.k, c.v, c.table_array([None if st is None else st.slot
                                     for st in states]),
            c.k_scale, c.v_scale, *lora)
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
        # padded rows (None) get an all-scratch table row, so their K/V
        # writes never land in a live slot's pages
        for i, st in enumerate(states):
            if st is None:
                continue
            eff = st.effective_prompt()
            ids[i, :eff.size] = eff
            lens[i] = eff.size
        t0 = self.clock()
        if self._t_first_work is None:
            self._t_first_work = t0
        logits = self._forward(ids, states, np.zeros((nb,), np.int32))
        last = logits[torch.arange(nb, device=self.device),
                      torch.from_numpy(lens - 1).to(self.device)]
        toks, ok = self._sample(last, states)
        now = self.clock()
        self._stats["prefill_dispatches"] += 1
        for i, st in enumerate(states):
            if st is None:
                continue
            self._stats["prefill_tokens"] += int(lens[i])
            if not ok[i]:
                self.scheduler.fail(st, "non-finite logits at prefill")
                continue
            self._accept_token(st, int(toks[i]), now)

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
            "kv_bytes_per_token": self.cache.kv_bytes_per_token(),
            "quota_deferred": self.scheduler.stats["quota_deferred"],
        }
