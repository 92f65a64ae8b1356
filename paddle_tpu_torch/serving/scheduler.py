"""Continuous-batching scheduler: iteration-level admission into fixed
batch slots.

Counterpart of ``paddle_tpu/serving/scheduler.py`` with the
``reject-new`` FIFO policy (no deadlines, priorities, drain or traces).
Scheduling happens between decode steps:

- a FIFO queue feeds ``max_batch_slots`` fixed slots; a request is
  admitted the step a slot AND enough KV pages free up, and its slot is
  released the step it finishes;
- with a ``tenant_quota``, a tenant holding that many slots waits while
  requests of other tenants behind it are admitted (each skip counts in
  ``stats["quota_deferred"]`` and ``tenant_deferrals``);
- with a LoRA manager, admission acquires the request's adapter and
  both ways a slot is released (termination, preemption) release it, so
  a reference is held exactly while the request is resident;
- admitted requests prefill in bucketed groups (``BucketTable``);
- when the page pool runs dry mid-decode, the newest-admitted request is
  preempted (recompute policy): its pages are freed, its prompt +
  tokens-so-far go back to the FRONT of the queue and it re-prefills
  later — for greedy decoding the continuation is token-identical.

All of this is host-side bookkeeping over ints.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .kv_cache import PagedKVCache, blocks_needed
from .sampling import SamplingParams

__all__ = ["Request", "RequestState", "BucketTable", "Scheduler",
           "AdmissionGroup", "ServerOverloaded"]

_request_ids = itertools.count()


class ServerOverloaded(RuntimeError):
    """The bounded queue refused a request (``reject-new`` policy)."""

    def __init__(self, reason: str, queue_depth: int = 0):
        super().__init__(f"server overloaded: {reason} "
                         f"(queue depth {queue_depth})")
        self.reason = reason
        self.queue_depth = queue_depth


@dataclass
class Request:
    """One generation request.

    ``on_token(request, token_id, text)`` streams every generated token
    the step it is produced (``text`` is None unless the engine has a
    detokenizer). ``eos_token_id`` ends the stream early; the eos token
    itself is reported and included. ``stop(generated_ids) -> bool`` is
    an optional custom stop condition evaluated after every token.
    ``tenant`` names the submitting tenant for the per-tenant quota
    (None: never quota-limited); ``adapter`` names a loaded LoRA adapter
    the request decodes against (None: the base model)."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token_id: Optional[int] = None
    on_token: Optional[Callable] = None
    stop: Optional[Callable] = None
    tenant: Optional[str] = None
    adapter: Optional[str] = None
    request_id: int = field(default_factory=lambda: next(_request_ids))

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class RequestState:
    """Scheduler-internal lifecycle record for one request."""

    def __init__(self, request: Request, now: float):
        self.request = request
        self.prompt_len = int(request.prompt.size)
        self.generated: List[int] = []
        self.slot: Optional[int] = None
        self.submitted_t = now
        self.admitted_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.preemptions = 0
        #: "completed" or "failed" once the request ends
        self.outcome: Optional[str] = None
        self.failure: Optional[str] = None
        self.stop_hit = False
        #: effective-prompt length this residency prefills (stamped at
        #: admission; effective_prompt() grows as tokens generate)
        self.prefill_len: Optional[int] = None

    @property
    def seq_len(self) -> int:
        """Positions held in the KV cache (prompt + generated tokens)."""
        return self.prompt_len + len(self.generated)

    def effective_prompt(self) -> np.ndarray:
        """What a (re-)prefill processes: the prompt plus any tokens
        generated before a preemption."""
        if not self.generated:
            return self.request.prompt
        return np.concatenate([self.request.prompt,
                               np.asarray(self.generated, np.int32)])

    def is_done(self) -> bool:
        if self.stop_hit:
            return True
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_token_id
        return eos is not None and bool(self.generated) \
            and self.generated[-1] == eos


class BucketTable:
    """Every prefill runs at a ``(batch_bucket, len_bucket)`` shape from
    this table. Decode has one shape, the full slot batch."""

    def __init__(self, prefill_lens: Sequence[int],
                 batch_sizes: Sequence[int]):
        if not prefill_lens or not batch_sizes:
            raise ValueError("bucket table needs >= 1 len and batch bucket")
        self.prefill_lens = tuple(sorted(set(int(x) for x in prefill_lens)))
        self.batch_sizes = tuple(sorted(set(int(x) for x in batch_sizes)))

    @property
    def max_prefill_len(self) -> int:
        return self.prefill_lens[-1]

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def len_bucket(self, n: int) -> int:
        for b in self.prefill_lens:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds the largest "
                         f"prefill bucket ({self.max_prefill_len})")

    def batch_bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.max_batch


@dataclass
class AdmissionGroup:
    """One bucketed prefill dispatch: ``states`` (already holding slots
    and pages) padded up to ``batch_bucket`` rows at ``len_bucket``
    columns by the engine."""

    len_bucket: int
    batch_bucket: int
    states: List[RequestState]


class Scheduler:
    """FIFO queue + slot/page admission control (host-side only)."""

    def __init__(self, cache: PagedKVCache, buckets: BucketTable,
                 max_queue: int = 1024, clock=time.perf_counter,
                 max_seq_len: Optional[int] = None,
                 tenant_quota: Optional[int] = None, lora=None):
        self.cache = cache
        self.buckets = buckets
        #: most slots one tenant may hold at a time; None = no cap
        self.tenant_quota = (int(tenant_quota)
                             if tenant_quota is not None else None)
        #: optional serving.lora.LoRAManager whose references admission
        #: and slot release keep
        self.lora = lora
        # the admission limit is the configured context window, not the
        # cache's block-rounded physical capacity
        self.max_seq_len = int(max_seq_len if max_seq_len is not None
                               else cache.max_context_len)
        self.max_queue = int(max_queue)
        self.clock = clock
        self.waiting: List[RequestState] = []
        self.slots: List[Optional[RequestState]] = [None] * cache.max_slots
        self.stats = {"submitted": 0, "completed": 0, "preemptions": 0,
                      "admitted": 0, "failed": 0, "quota_deferred": 0}
        #: cumulative quota deferrals per tenant
        self.tenant_deferrals: Dict[str, int] = {}

    # -- terminal transitions ----------------------------------------------
    def _terminate(self, st: RequestState, outcome: str,
                   reason: Optional[str] = None) -> None:
        """The one exit path: frees any held slot/pages and stamps
        exactly one outcome."""
        if st.outcome is not None:
            raise RuntimeError(f"request {st.request.request_id} already "
                               f"{st.outcome}")
        if st.slot is not None:
            self._release_adapter(st)
            self.cache.free_slot(st.slot)
            self.slots[st.slot] = None
            st.slot = None
        st.outcome = outcome
        st.failure = reason
        self.stats[outcome] += 1

    # -- queue --------------------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        if request.prompt.size + request.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({request.prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the per-slot context "
                f"capacity ({self.max_seq_len})")
        # a request that could never hold its pages even alone in the
        # pool would stall admission forever: reject it here
        alloc = self.cache.allocator
        need = blocks_needed(request.prompt.size + request.max_new_tokens,
                             self.cache.block_size)
        if need > alloc.num_pages - alloc.reserved:
            raise ValueError(
                f"request needs {need} KV pages at full length but the "
                f"pool only holds {alloc.num_pages - alloc.reserved} — "
                "raise ServingConfig.num_pages or shrink the request")
        # the bucket table must be able to re-prefill this request even
        # after a worst-case preemption (prompt + all generated tokens)
        self.buckets.len_bucket(
            request.prompt.size + request.max_new_tokens - 1)
        if len(self.waiting) >= self.max_queue:
            raise ServerOverloaded("queue_full",
                                   queue_depth=len(self.waiting))
        st = RequestState(request, self.clock())
        self.waiting.append(st)
        self.stats["submitted"] += 1
        return st

    def fail(self, st: RequestState, reason: str) -> None:
        """Fault isolation: a bad request fails alone (its slot and
        pages are released; the rest of the batch streams on)."""
        if st in self.waiting:
            self.waiting.remove(st)
        self._terminate(st, "failed", reason=reason)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def active(self) -> List[Tuple[int, RequestState]]:
        return [(i, st) for i, st in enumerate(self.slots)
                if st is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            st is not None for st in self.slots)

    # -- admission ----------------------------------------------------------
    def plan_admissions(self) -> List[RequestState]:
        """Admit waiting requests FIFO while slots and pages allow: slot
        assigned, pages allocated for the effective prompt,
        ``prefill_len`` stamped, adapter acquired. A request whose
        tenant is at its quota is skipped (later tenants still admit); a
        request whose adapter is no longer loaded fails alone. Returns
        the newly admitted states in admission order (the engine groups
        them into prefills)."""
        admitted: List[RequestState] = []
        free_slots = [i for i, st in enumerate(self.slots) if st is None]
        # idx passes quota-blocked requests; without a quota it stays 0
        # and the loop is the plain FIFO
        idx = 0
        while free_slots and idx < len(self.waiting):
            st = self.waiting[idx]
            tenant = st.request.tenant
            if self.tenant_quota is not None and tenant is not None \
                    and self._tenant_active(tenant) >= self.tenant_quota:
                self.stats["quota_deferred"] += 1
                self.tenant_deferrals[tenant] = \
                    self.tenant_deferrals.get(tenant, 0) + 1
                idx += 1
                continue
            adapter = st.request.adapter
            if adapter and (self.lora is None
                            or self.lora.row(adapter) is None):
                # unloaded between submit and admission: fail this
                # request rather than serve it the zero adapter
                self.waiting.pop(idx)
                self._terminate(st, "failed",
                                reason=f"adapter {adapter!r} not loaded")
                continue
            slot = free_slots[0]
            eff = st.effective_prompt()
            if not self.cache.alloc_slot(slot, eff.size):
                break                      # page pool dry: FIFO blocks
            self.waiting.pop(idx)
            free_slots.pop(0)
            st.slot = slot
            st.admitted_t = self.clock()
            st.prefill_len = int(eff.size)
            self.slots[slot] = st
            if self.lora is not None and adapter:
                self.lora.acquire(adapter)
            admitted.append(st)
            self.stats["admitted"] += 1
        return admitted

    # -- decode-time growth / preemption ------------------------------------
    def ensure_decode_capacity(self) -> List[RequestState]:
        """Before a decode step, make sure every active slot has a page
        for the position it is about to write (``seq_len - 1``). On a
        dry pool, preempt newest-admitted requests (recompute policy)
        until the older ones fit. Returns the preempted states (already
        requeued at the queue front)."""
        preempted: List[RequestState] = []
        # oldest first: earlier-admitted requests keep their pages
        order = sorted(self.active(), key=lambda p: p[1].admitted_t)
        for slot, st in order:
            if self.slots[slot] is not st:
                continue                       # preempted below, skip
            while not self.cache.extend_slot(slot, st.seq_len):
                victim = self._newest_active(exclude=st)
                if victim is None:
                    raise RuntimeError(
                        "KV page pool too small for a single request: "
                        f"{st.seq_len} tokens need more pages than the "
                        "pool holds — raise num_pages or shrink "
                        "max_new_tokens")
                self._preempt(victim)
                preempted.append(victim)
        return preempted

    def _newest_active(self, exclude: RequestState) \
            -> Optional[RequestState]:
        cands = [st for _, st in self.active() if st is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda s: s.admitted_t)

    def _release_adapter(self, st: RequestState) -> None:
        """Drop the slot's adapter reference; called on both ways a slot
        is released (:meth:`_terminate`, :meth:`_preempt`)."""
        if self.lora is not None and st.request.adapter:
            self.lora.release(st.request.adapter)

    def _tenant_active(self, tenant: str) -> int:
        """Slots ``tenant`` holds (the quota currency)."""
        return sum(1 for st in self.slots
                   if st is not None and st.request.tenant == tenant)

    def _preempt(self, st: RequestState) -> None:
        self._release_adapter(st)
        self.cache.free_slot(st.slot)
        self.slots[st.slot] = None
        st.slot = None
        st.admitted_t = None
        st.prefill_len = None
        st.preemptions += 1
        self.stats["preemptions"] += 1
        self.waiting.insert(0, st)         # reclaims FIFO priority

    # -- completion ---------------------------------------------------------
    def finish(self, st: RequestState) -> None:
        if st.slot is None:
            raise RuntimeError(f"request {st.request.request_id} holds no "
                               "slot")
        self._terminate(st, "completed")
