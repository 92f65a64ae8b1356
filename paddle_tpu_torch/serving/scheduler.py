"""Continuous-batching scheduler: iteration-level admission into fixed
batch slots.

Counterpart of ``paddle_tpu/serving/scheduler.py``. Scheduling happens
between decode steps:

- a bounded queue feeds ``max_batch_slots`` fixed slots; a request is
  admitted the step a slot AND enough KV pages free up, and its slot is
  released the step it finishes;
- a full queue sheds by policy (``QUEUE_POLICIES``): ``reject-new``
  refuses the newcomer, ``drop-oldest`` sheds the head of the queue,
  ``priority`` keeps the queue in priority lanes (FIFO within a lane)
  and sheds the lowest-priority, oldest waiter for a newcomer that
  outranks it;
- a request with ``deadline_s`` expires in the queue before it touches
  a slot (``expire_queued``) or at the next iteration boundary in
  flight (``sweep_active``), which also honours latched cancels;
- with a radix prefix cache on the cache (``serving.prefix_cache``),
  admission maps the longest cached page-aligned prefix of the
  effective prompt copy-on-write into the slot (``prefill_pos`` starts
  at the hit), and both ways a slot is released donate the tokens its
  pages validly hold, except after a failure;
- a request prefills from ``prefill_pos`` to ``prefill_len``, in one
  dispatch or in chunks (``prefilling`` until it is done), and then
  decodes; a staged speculative ``draft`` gets its pages before the
  verify dispatch;
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

Every request ends in exactly one of ``TERMINAL_OUTCOMES``, and every
terminal transition fires ``on_event(outcome, state)`` (the
engine's metrics, flight events, SLO and trace closure); the chaos site
``serve.pages.exhaust`` makes admission wait, or recompute-preempts the
newest request, for one decision, as in the JAX scheduler. All of this
is host-side bookkeeping over ints.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..testing import chaos
from .kv_cache import PagedKVCache, blocks_needed
from .resilience import ServerOverloaded
from .sampling import SamplingParams

__all__ = ["Request", "RequestState", "BucketTable", "Scheduler",
           "AdmissionGroup", "ServerOverloaded", "QUEUE_POLICIES",
           "TERMINAL_OUTCOMES"]

#: bounded-queue shedding policies (ServingConfig.queue_policy)
QUEUE_POLICIES = ("reject-new", "drop-oldest", "priority")

#: every request ends in exactly one of these; "completed" is the only
#: success
TERMINAL_OUTCOMES = ("completed", "expired", "shed", "cancelled",
                     "failed", "drained")

_request_ids = itertools.count()


def _reset_request_ids() -> None:
    global _request_ids
    _request_ids = itertools.count()


@dataclass
class Request:
    """One generation request.

    ``on_token(request, token_id, text)`` streams every generated token
    the step it is produced (``text`` is None unless the engine has a
    detokenizer). ``eos_token_id`` ends the stream early; the eos token
    itself is reported and included. ``deadline_s`` is a time to live
    from submission: a queued request past it expires before it touches
    a slot, an in-flight one at the next iteration boundary (its pages
    freed then). ``priority`` feeds the ``priority`` queue policy
    (higher is more important; ties stay FIFO). ``stop(generated_ids)
    -> bool`` is an optional custom stop condition evaluated after every
    token.
    ``tenant`` names the submitting tenant for the per-tenant quota
    (None: never quota-limited); ``adapter`` names a loaded LoRA adapter
    the request decodes against (None: the base model). ``trace_*``
    carry a caller's trace context (``FLAGS_trace``): an identity to
    resume, a parent span, the producing process's label and the
    upstream head-sampling decision. The fields bind positionally in
    the JAX ``Request``'s order."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token_id: Optional[int] = None
    on_token: Optional[Callable] = None
    deadline_s: Optional[float] = None
    priority: int = 0
    stop: Optional[Callable] = None
    trace_id: Optional[str] = None
    trace_parent: Optional[str] = None
    trace_process: Optional[str] = None
    trace_sampled: Optional[bool] = None
    tenant: Optional[str] = None
    adapter: Optional[str] = None
    request_id: int = field(default_factory=lambda: next(_request_ids))

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (None = no deadline)")


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
        self.finished_t: Optional[float] = None
        self.preemptions = 0
        self.finished = False
        #: one of TERMINAL_OUTCOMES once the request ends
        self.outcome: Optional[str] = None
        #: human-readable reason for outcome == "failed"
        self.failure: Optional[str] = None
        #: absolute deadline on the scheduler's clock
        self.deadline_t: Optional[float] = (
            now + request.deadline_s if request.deadline_s is not None
            else None)
        #: client disconnect latched; honoured at the iteration boundary
        self.cancel_requested = False
        self.stop_hit = False
        #: effective-prompt length this residency prefills (stamped at
        #: admission; effective_prompt() grows as tokens generate)
        self.prefill_len: Optional[int] = None
        #: prompt positions whose K/V are already in the slot's pages:
        #: admission seeds it with the prefix-cache hit, each prefill
        #: chunk advances it; reset on preemption
        self.prefill_pos = 0
        #: speculative draft tokens staged for the next verify dispatch
        #: (never part of ``generated`` until the verifier accepts them)
        self.draft: List[int] = []
        #: chaos serve.request.poison marked this request
        self.poisoned = False
        #: weights epoch of the tree that wrote this residency's first
        #: K/V (stamped at its first prefill chunk, or by a hot-swap
        #: cutover); it finishes on that tree. None until then, and
        #: again after a preemption
        self.weights_epoch: Optional[int] = None
        #: structured-tracing context: the engine attaches a Trace and
        #: its open spans under FLAGS_trace; the scheduler never reads
        #: them
        self.trace = None
        self.trace_spans: dict = {}

    @property
    def terminal(self) -> bool:
        return self.outcome is not None

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

    def remaining_new_tokens(self) -> int:
        return self.request.max_new_tokens - len(self.generated)

    @property
    def prefilling(self) -> bool:
        """Holds a slot but has not finished its (possibly chunked)
        prefill: it takes no decode row yet."""
        return self.slot is not None and self.prefill_len is not None \
            and self.prefill_pos < self.prefill_len

    def written_tokens(self) -> np.ndarray:
        """The token ids whose K/V the slot's pages validly hold now,
        the prefix-cache donation: mid-prefill the chunk progress;
        decoding, everything but the newest generated token (whose K/V
        the next dispatch writes)."""
        eff = self.effective_prompt()
        if self.prefilling or not self.generated:
            return eff[:self.prefill_pos]
        return eff[:self.seq_len - 1]

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

    def signatures(self) -> List[Tuple[int, int]]:
        return [(b, s) for s in self.prefill_lens for b in self.batch_sizes]


@dataclass
class AdmissionGroup:
    """One bucketed prefill dispatch: ``states`` (already holding slots
    and pages) padded up to ``batch_bucket`` rows at ``len_bucket``
    columns by the engine."""

    len_bucket: int
    batch_bucket: int
    states: List[RequestState]


class Scheduler:
    """Bounded queue + slot/page admission control (host-side only).

    A ``follower`` (an mp rank other than 0 of a tensor-parallel engine,
    ``serving.lockstep``) decides nothing that reads its clock: its
    expiry and cancel sweeps do nothing, a cancel only latches, and the
    engine applies the leader's decisions through :meth:`end_as`,
    :meth:`admit_as` and :meth:`apply_preemptions`."""

    def __init__(self, cache: PagedKVCache, buckets: BucketTable,
                 max_queue: int = 1024, clock=time.perf_counter,
                 max_seq_len: Optional[int] = None,
                 policy: str = "reject-new",
                 on_event: Optional[Callable] = None,
                 tenant_quota: Optional[int] = None, lora=None,
                 follower: bool = False):
        self.follower = bool(follower)
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
        if policy not in QUEUE_POLICIES:
            raise ValueError(f"unknown queue policy {policy!r}; one of "
                             f"{QUEUE_POLICIES}")
        self.policy = policy
        self.clock = clock
        self.waiting: List[RequestState] = []
        self.slots: List[Optional[RequestState]] = [None] * cache.max_slots
        self.stats = {"submitted": 0, "completed": 0, "preemptions": 0,
                      "admitted": 0, "expired": 0, "expired_queued": 0,
                      "shed": 0, "cancelled": 0, "failed": 0,
                      "drained": 0, "quota_deferred": 0}
        #: cumulative quota deferrals per tenant
        self.tenant_deferrals: Dict[str, int] = {}
        #: ``on_event(outcome, state)`` fires on every terminal transition
        self.on_event = on_event
        # deadline sweeps cost nothing until the first request with a
        # deadline arrives
        self._saw_deadline = False

    # -- terminal transitions ----------------------------------------------
    def _terminate(self, st: RequestState, outcome: str,
                   reason: Optional[str] = None) -> None:
        """The one exit path: frees any held slot/pages, stamps exactly
        one outcome, counts it and fires ``on_event``."""
        if st.outcome is not None:
            raise RuntimeError(f"request {st.request.request_id} already "
                               f"{st.outcome}")
        if st.slot is not None:
            self._release_adapter(st)
            # the K/V this residency computed seeds later prefix hits,
            # except a failed request's (a non-finite forward may have
            # written garbage)
            donate = st.written_tokens() if outcome != "failed" else None
            self.cache.free_slot(st.slot, donate_tokens=donate)
            self.slots[st.slot] = None
            st.slot = None
        st.draft = []
        st.outcome = outcome
        st.failure = reason
        st.finished = outcome == "completed"
        st.finished_t = self.clock()
        self.stats[outcome] += 1
        if self.on_event is not None:
            self.on_event(outcome, st)

    def _shed_victim(self, request: Request) -> Optional[RequestState]:
        """Who leaves the full queue so ``request`` can enter (None:
        nobody, the newcomer is refused)."""
        if self.policy == "drop-oldest":
            return self.waiting[0] if self.waiting else None
        if self.policy == "priority":
            # the lowest priority, the oldest within it (min keeps the
            # first of equals, and lanes are FIFO), and only when the
            # newcomer outranks it
            victim = min(self.waiting, default=None,
                         key=lambda s: s.request.priority)
            if victim is not None \
                    and victim.request.priority < request.priority:
                return victim
        return None

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
        # the queue-full policy runs after validation (an invalid request
        # never sheds a valid waiter), and after the expiry sweep (a dead
        # waiter holds no capacity and is never mis-counted as shed)
        self.expire_queued()
        if len(self.waiting) >= self.max_queue:
            victim = self._shed_victim(request)
            if victim is None:
                raise ServerOverloaded("queue_full",
                                       queue_depth=len(self.waiting))
            self.waiting.remove(victim)
            self._terminate(victim, "shed")
        st = RequestState(request, self.clock())
        if st.deadline_t is not None:
            self._saw_deadline = True
        if self.policy == "priority":
            # behind the last waiter of >= priority
            idx = next((i for i, w in enumerate(self.waiting)
                        if w.request.priority < request.priority),
                       len(self.waiting))
            self.waiting.insert(idx, st)
        else:
            self.waiting.append(st)
        self.stats["submitted"] += 1
        return st

    def cancel(self, request_id: int) -> bool:
        """Client disconnect: a queued request is cancelled on the spot,
        an in-flight one latched and cancelled at the next iteration
        boundary (``sweep_active``), its pages freed then. False when
        the id is unknown or already terminal. A follower only latches:
        the leader's cancel reaches it at the next boundary."""
        if self.follower:
            st = self.find(request_id)
            if st is None or st.outcome is not None:
                return False
            st.cancel_requested = True
            return True
        for st in self.waiting:
            if st.request.request_id == request_id:
                self.waiting.remove(st)
                self._terminate(st, "cancelled")
                return True
        for _, st in self.active():
            if st.request.request_id == request_id:
                st.cancel_requested = True
                return True
        return False

    def expire_queued(self) -> List[RequestState]:
        """Drop queued requests past their deadline before they touch a
        slot. Free until the first request with a deadline exists."""
        if self.follower or not self._saw_deadline or not self.waiting:
            return []
        now = self.clock()
        out = []
        for st in [w for w in self.waiting
                   if w.deadline_t is not None and now >= w.deadline_t]:
            self.waiting.remove(st)
            self._terminate(st, "expired")
            # a queued expiry cost the engine no work: shed-rate
            # accounting counts it with the admission drops
            self.stats["expired_queued"] += 1
            out.append(st)
        return out

    def sweep_active(self) -> List[RequestState]:
        """Iteration-boundary sweep over the slots: honour latched
        cancels and expire in-flight requests past their deadline,
        freeing their pages now."""
        out = []
        if self.follower:
            return out
        for _, st in list(self.active()):
            if st.cancel_requested:
                self._terminate(st, "cancelled")
                out.append(st)
            elif st.deadline_t is not None \
                    and self.clock() >= st.deadline_t:
                self._terminate(st, "expired")
                out.append(st)
        return out

    def honour_queued_cancels(self) -> List[RequestState]:
        """Terminate waiting requests whose in-flight cancel was latched
        before a preemption put them back in the queue (admission honours
        the latch lazily; a drain calls this so that a disconnected
        client's work is never snapshotted)."""
        out = []
        if self.follower:
            return out
        for st in [w for w in self.waiting if w.cancel_requested]:
            self.waiting.remove(st)
            self._terminate(st, "cancelled")
            out.append(st)
        return out

    def fail(self, st: RequestState, reason: str) -> None:
        """Fault isolation: a bad request fails alone (its slot and
        pages are released; the rest of the batch streams on)."""
        if st in self.waiting:
            self.waiting.remove(st)
        self._terminate(st, "failed", reason=reason)

    def drain_release(self, st: RequestState) -> None:
        """Graceful drain: release a queued or in-flight request with
        outcome ``drained``; its undone work is in the snapshot."""
        if st in self.waiting:
            self.waiting.remove(st)
        self._terminate(st, "drained")

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def oldest_waiting_t(self) -> Optional[float]:
        """``submitted_t`` of the oldest waiter, None for an empty
        queue. Under the ``priority`` policy the queue is in lanes, so the
        oldest waiter (the one the overload detector must see, or a
        starving low-priority request could age without tripping it) need
        not be ``waiting[0]``."""
        if not self.waiting:
            return None
        if self.policy == "priority":
            return min(st.submitted_t for st in self.waiting)
        return self.waiting[0].submitted_t

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
        assigned, pages allocated for the effective prompt (with any
        prefix-cache hit mapped copy-on-write), ``prefill_pos`` /
        ``prefill_len`` stamped, adapter acquired. A request whose
        tenant is at its quota is skipped (later tenants still admit); a
        request whose adapter is no longer loaded fails alone. Returns
        the newly admitted states in admission order (the engine groups
        them into prefills)."""
        admitted: List[RequestState] = []
        free_slots = [i for i, st in enumerate(self.slots) if st is None]
        if self.waiting and free_slots and chaos.active() \
                and chaos.probe("serve.pages.exhaust"):
            return []                  # injected dry pool: admission waits
        # idx passes quota-blocked requests; without a quota it stays 0
        # and the loop is the plain FIFO
        idx = 0
        while free_slots and idx < len(self.waiting):
            st = self.waiting[idx]
            if st.cancel_requested:
                # a cancel latched in flight survives a preemption back
                # to the queue: honour it, never prefill it again
                self.waiting.pop(idx)
                self._terminate(st, "cancelled")
                continue
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
            if not self._admit(idx, free_slots[0], self.clock()):
                break                      # page pool dry: FIFO blocks
            free_slots.pop(0)
            admitted.append(st)
        return admitted

    def _admit(self, idx: int, slot: int, admitted_t: float) -> bool:
        """Admit ``waiting[idx]`` into ``slot``: pages for its effective
        prompt (a prefix-cache hit mapped copy-on-write), the prefill
        stamps, the adapter reference. False (nothing changed) when the
        pool cannot hold it."""
        st = self.waiting[idx]
        eff = st.effective_prompt()
        # match() increfs the hit pages; a failed alloc_slot drops them
        # again, so the retry next iteration re-matches
        n_hit, shared = 0, ()
        if self.cache.prefix_cache is not None:
            n_hit, shared = self.cache.prefix_cache.match(eff)
        if not self.cache.alloc_slot(slot, eff.size, shared_pages=shared):
            return False
        self.waiting.pop(idx)
        st.slot = slot
        st.admitted_t = admitted_t
        st.prefill_pos = n_hit
        st.prefill_len = int(eff.size)
        self.slots[slot] = st
        if self.lora is not None and st.request.adapter:
            self.lora.acquire(st.request.adapter)
        self.stats["admitted"] += 1
        return True

    # -- a follower's side of the lockstep ------------------------------------
    def find(self, request_id: int) -> Optional[RequestState]:
        """The queued or slot-holding state of ``request_id``, or None."""
        for st in self.waiting:
            if st.request.request_id == request_id:
                return st
        for st in self.slots:
            if st is not None and st.request.request_id == request_id:
                return st
        return None

    def end_as(self, st: RequestState, outcome: str) -> None:
        """End ``st`` as the leader ended it."""
        queued = st in self.waiting
        if queued:
            self.waiting.remove(st)
        self._terminate(st, outcome)
        if outcome == "expired" and queued:
            self.stats["expired_queued"] += 1

    def admit_as(self, request_id: int, slot: int,
                 admitted_t: float) -> RequestState:
        """Admit ``request_id`` into ``slot`` with the leader's stamp."""
        from .lockstep import LockstepError
        idx = next((i for i, st in enumerate(self.waiting)
                    if st.request.request_id == request_id), None)
        if idx is None or self.slots[slot] is not None:
            raise LockstepError(
                f"the leader admitted request {request_id} into slot "
                f"{slot}, which this rank cannot: "
                + ("the request is not queued here" if idx is None
                   else "the slot is taken"))
        st = self.waiting[idx]
        if not self._admit(idx, slot, admitted_t):
            raise LockstepError(
                f"the leader admitted request {request_id}, for which "
                "this rank's page pool has no room")
        return st

    def apply_preemptions(self, ids: Sequence[int]) -> List[RequestState]:
        """Preempt the leader's ``ids``, then give every slot its pages
        for the coming dispatch (as :meth:`ensure_decode_capacity` did on
        the leader). Returns the preempted states."""
        from .lockstep import LockstepError
        out = []
        for rid in ids:
            st = self.find(rid)
            if st is None or st.slot is None:
                raise LockstepError(f"the leader preempted request {rid}, "
                                    "which holds no slot on this rank")
            self._preempt(st)
            out.append(st)
        for slot, st in sorted(self.active(), key=lambda p: p[1].admitted_t):
            if not self.cache.extend_slot(slot, st.seq_len + len(st.draft)):
                raise LockstepError(
                    f"request {st.request.request_id} cannot grow on this "
                    "rank's page pool, where the leader's could")
        return out

    # -- decode-time growth / preemption ------------------------------------
    def ensure_decode_capacity(self) -> List[RequestState]:
        """Before a decode step, make sure every active slot has a page
        for the position it is about to write (``seq_len - 1``) and for
        a staged draft's positions after it (a draft's K/V must never
        spill into the scratch page: the verify window's rows read them
        back). On a dry pool, preempt newest-admitted requests
        (recompute policy) until the older ones fit. Returns the
        preempted states (already requeued at the queue front)."""
        preempted: List[RequestState] = []
        if len(self.active()) >= 2 and chaos.active() \
                and chaos.probe("serve.pages.exhaust"):
            # injected pool pressure: recompute-preempt the newest
            # admitted request, the oldest kept so the batch progresses
            oldest = min(self.active(), key=lambda p: p[1].admitted_t)[1]
            victim = self._newest_active(exclude=oldest)
            if victim is not None:
                self._preempt(victim)
                preempted.append(victim)
        # oldest first: earlier-admitted requests keep their pages
        order = sorted(self.active(), key=lambda p: p[1].admitted_t)
        for slot, st in order:
            if self.slots[slot] is not st:
                continue                       # preempted below, skip
            while not self.cache.extend_slot(slot,
                                             st.seq_len + len(st.draft)):
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

    def _preempt(self, st: RequestState, count: bool = True) -> None:
        self._release_adapter(st)
        # an evicted residency donates too: its pages stay warm in the
        # tree for its re-admission or a sibling sharing the prefix
        self.cache.free_slot(st.slot, donate_tokens=st.written_tokens())
        self.slots[st.slot] = None
        st.slot = None
        st.admitted_t = None
        st.prefill_pos = 0
        st.prefill_len = None
        st.weights_epoch = None
        st.draft = []
        if count:
            st.preemptions += 1
            self.stats["preemptions"] += 1
        if self.policy == "priority":
            # the front of its lane: it held a slot once
            idx = next((i for i, w in enumerate(self.waiting)
                        if w.request.priority <= st.request.priority),
                       len(self.waiting))
            self.waiting.insert(idx, st)
        else:
            self.waiting.insert(0, st)         # reclaims FIFO priority

    def rollback_admission(self, sts: Sequence[RequestState]) -> None:
        """Un-admit states whose prefill never produced a token (a
        watchdog trip abandoned the dispatch): each goes back to the
        queue front with everything its admission took released (pages,
        prefix-cache references, the adapter reference, chunk progress),
        so a retried ``step()`` re-admits and re-prefills it. Reversed so
        the front inserts keep admission order. Not counted as a
        preemption: a watchdog incident is not a dry KV pool."""
        for st in reversed(list(sts)):
            if st.slot is not None and self.slots[st.slot] is st:
                self._preempt(st, count=False)

    # -- completion ---------------------------------------------------------
    def finish(self, st: RequestState) -> None:
        if st.slot is None:
            raise RuntimeError(f"request {st.request.request_id} holds no "
                               "slot")
        self._terminate(st, "completed")
