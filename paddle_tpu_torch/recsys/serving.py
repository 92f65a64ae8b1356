"""Online recsys serving: batched lookup + ranking under the serving
discipline.

Recsys inference is the latency-critical half of the workload: a
request carries a user context and K candidate items, the engine must
return ranked scores inside a deadline, and under overload it must
shed load EARLY (a recommendation delivered late is worthless — unlike
an LLM token stream there is nothing to resume). This engine rides the
serving machinery rather than reinventing it:

- **admission control**: a bounded queue with the reject-new /
  drop-oldest policies; refused submits raise the same typed
  :class:`~paddle_tpu_torch.serving.resilience.ServerOverloaded` the
  LLM engine raises, and the queue-delay EWMA
  :class:`~paddle_tpu_torch.serving.resilience.OverloadDetector` (enter/exit
  hysteresis, idle decay at submit) flips the engine into a shedding
  state;
- **deadlines**: queued requests past their deadline expire at the
  iteration boundary BEFORE any table row is fetched; completions
  observe their slack into ``recsys_deadline_slack_seconds``;
- **batched dedup lookups**: one engine step stacks every admitted
  request's candidates into ONE model forward, so the embedding pull
  dedups across requests (hot ids shared between users cost one row);
- **telemetry**: ``recsys_lookup_seconds`` / ``recsys_rank_seconds``
  (the model's embedding-vs-MLP wall split), e2e latency, request
  outcome counters, queue/overload gauges — and each step republishes
  the tier hit/occupancy metrics of every table that has them
  (``tools/monitor_report.py --recsys`` renders the lot).

Counterpart of ``paddle_tpu/recsys/serving.py``: the same engine over the
port's model, whose forward runs under ``torch.no_grad()`` on the model's
device and comes back as numpy scores.
"""

from __future__ import annotations

import itertools
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..monitor import get_registry
from ..serving.resilience import OverloadDetector, ServerOverloaded

__all__ = ["RecsysRequest", "RecsysResult", "RecsysServingConfig",
           "RecsysEngine", "reset_engines"]

_req_ids = itertools.count(1)
_LIVE_ENGINES: "weakref.WeakSet[RecsysEngine]" = weakref.WeakSet()


@dataclass
class RecsysRequest:
    """One ranking request: a user context (dense features) and K
    candidate items, each a full sparse-slot row ``[num_sparse]``."""

    dense: np.ndarray
    candidate_ids: np.ndarray          # [K, num_sparse] int64
    deadline_s: Optional[float] = None
    priority: int = 0
    on_result: Optional[Callable] = None
    request_id: int = field(default_factory=lambda: next(_req_ids))


@dataclass
class RecsysResult:
    request_id: int
    scores: np.ndarray                 # [K] click logits
    order: np.ndarray                  # candidate indices, best first
    e2e_s: float = 0.0


class _State:
    __slots__ = ("request", "submitted_t", "deadline_t", "outcome",
                 "result", "failure")

    def __init__(self, request: RecsysRequest, now: float):
        self.request = request
        self.submitted_t = now
        self.deadline_t = (now + request.deadline_s
                           if request.deadline_s is not None else None)
        self.outcome: Optional[str] = None
        self.result: Optional[RecsysResult] = None
        self.failure: Optional[str] = None


@dataclass
class RecsysServingConfig:
    #: requests ranked per engine step (their candidates batch into one
    #: forward — the cross-request dedup window)
    max_batch: int = 8
    max_queue: int = 256
    #: bounded-queue shedding policy: reject-new | drop-oldest
    queue_policy: str = "reject-new"
    #: queue-delay EWMA overload detector (0 = off)
    overload_threshold_s: float = 0.0
    overload_alpha: float = 0.3
    overload_exit_frac: float = 0.5
    #: republish tier hit/occupancy metrics each step
    publish_tier_metrics: bool = True


class RecsysEngine:
    """Drive a :class:`~paddle_tpu_torch.models.dlrm.DLRM` (or any model with
    ``forward(dense, ids) -> logits`` and ``last_timings``) as an
    online ranking service."""

    QUEUE_POLICIES = ("reject-new", "drop-oldest")

    def __init__(self, model, config: Optional[RecsysServingConfig] = None,
                 clock=time.perf_counter):
        self.model = model
        self.config = config or RecsysServingConfig()
        if self.config.queue_policy not in self.QUEUE_POLICIES:
            raise ValueError(
                f"unknown queue_policy {self.config.queue_policy!r}; "
                f"one of {self.QUEUE_POLICIES}")
        self.clock = clock
        self._queue: List[_State] = []
        self._overload = (OverloadDetector(
            self.config.overload_threshold_s,
            alpha=self.config.overload_alpha,
            exit_frac=self.config.overload_exit_frac)
            if self.config.overload_threshold_s > 0 else None)
        self.stats = {"submitted": 0, "completed": 0, "expired": 0,
                      "rejected": 0, "shed": 0, "failed": 0, "steps": 0,
                      "candidates_scored": 0}
        self._lat: Dict[str, List[float]] = {"e2e": [], "lookup": [],
                                             "rank": []}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        _LIVE_ENGINES.add(self)

    # -- events --------------------------------------------------------------
    def _count(self, event: str) -> None:
        get_registry().counter(
            "recsys_requests_total",
            "recsys ranking requests by lifecycle event").inc(event=event)

    def _terminate(self, st: _State, outcome: str) -> None:
        st.outcome = outcome
        self.stats[outcome] += 1
        self._count(outcome)

    def _publish_gauges(self) -> None:
        get_registry().gauge(
            "recsys_queue_depth",
            "ranking requests waiting for an engine step").set(
            len(self._queue))

    # -- request surface -----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, request: RecsysRequest) -> _State:
        now = self.clock()
        if self._overload is not None and self._overload.overloaded:
            if not self._queue:
                # idle engine: fold the empty-queue delay sample here or
                # a tripped detector latches forever
                transition = self._overload.observe(0.0)
                if transition is not None:
                    self._overload_transition(transition)
            if self._overload is not None and self._overload.overloaded:
                self.stats["rejected"] += 1
                self._count("rejected")
                raise ServerOverloaded(
                    "overload", queue_depth=len(self._queue),
                    ewma_s=self._overload.ewma_s,
                    threshold_s=self._overload.threshold_s)
        if len(self._queue) >= self.config.max_queue:
            if self.config.queue_policy == "drop-oldest":
                victim = self._queue.pop(0)
                self._terminate(victim, "shed")
            else:
                self.stats["rejected"] += 1
                self._count("rejected")
                raise ServerOverloaded(
                    "queue_full", queue_depth=len(self._queue))
        st = _State(request, now)
        self._queue.append(st)
        self.stats["submitted"] += 1
        self._count("submitted")
        self._publish_gauges()
        return st

    def _overload_transition(self, transition: str) -> None:
        reg = get_registry()
        reg.gauge("recsys_overload",
                  "1 while the recsys queue-delay overload detector is "
                  "tripped (new submits are shed)").set(
            float(transition == "enter"))
        reg.counter("recsys_overload_transitions_total",
                    "recsys overload detector state changes").inc(
            state=transition)

    # -- the serving iteration ----------------------------------------------
    def step(self) -> bool:
        """One iteration: expire stale queued requests, rank one batch.
        Returns whether work remains."""
        now = self.clock()
        self.stats["steps"] += 1
        keep: List[_State] = []
        for st in self._queue:
            if st.deadline_t is not None and now >= st.deadline_t:
                # expire BEFORE any row is fetched: a blown deadline
                # must not spend table bandwidth
                self._terminate(st, "expired")
            else:
                keep.append(st)
        self._queue = keep
        if self._overload is not None:
            delay = (now - self._queue[0].submitted_t
                     if self._queue else 0.0)
            transition = self._overload.observe(delay)
            if transition is not None:
                self._overload_transition(transition)
        batch = self._queue[:self.config.max_batch]
        self._queue = self._queue[len(batch):]
        if batch:
            self._rank(batch)
        self._publish_gauges()
        if self.config.publish_tier_metrics:
            for t in {id(t): t for e in getattr(self.model, "embeddings",
                                                [])
                      for t in [e.table]}.values():
                pub = getattr(t, "publish_tier_metrics", None)
                if pub is not None:
                    pub()
        return bool(self._queue)

    def _forward(self, dense: np.ndarray, ids: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.model(dense, ids).float().cpu().numpy()

    def _observe_phase(self) -> None:
        reg = get_registry()
        tm = getattr(self.model, "last_timings", {})
        look, rank = tm.get("lookup_s", 0.0), tm.get("mlp_s", 0.0)
        self._lat["lookup"].append(look)
        self._lat["rank"].append(rank)
        reg.histogram("recsys_lookup_seconds",
                      "embedding lookup wall time per ranking batch"
                      ).observe(look)
        reg.histogram("recsys_rank_seconds",
                      "MLP + interaction wall time per ranking batch"
                      ).observe(rank)

    def _complete(self, st: _State, scores: np.ndarray,
                  now: float) -> None:
        reg = get_registry()
        order = np.argsort(-scores, kind="stable")
        e2e = now - st.submitted_t
        st.result = RecsysResult(st.request.request_id,
                                 scores.copy(), order, e2e_s=e2e)
        self._terminate(st, "completed")
        self.stats["candidates_scored"] += scores.size
        self._lat["e2e"].append(e2e)
        reg.histogram("recsys_e2e_seconds",
                      "submit -> ranked-results latency").observe(e2e)
        if st.deadline_t is not None:
            reg.histogram(
                "recsys_deadline_slack_seconds",
                "deadline minus completion time (negative = ranked "
                "late, only possible within one engine step)",
                buckets=(-1.0, -0.1, 0.0, 0.05, 0.1, 0.25, 0.5,
                         1.0, 2.0, 5.0, 30.0)).observe(
                st.deadline_t - now)
        if st.request.on_result is not None:
            st.request.on_result(st.result)

    @staticmethod
    def _dense_rows(st: _State, k: int) -> np.ndarray:
        return np.broadcast_to(
            np.asarray(st.request.dense, np.float32),
            (k, len(st.request.dense)))

    def _rank(self, batch: List[_State]) -> None:
        if self._t_first is None:
            self._t_first = self.clock()
        sizes = [int(st.request.candidate_ids.shape[0]) for st in batch]
        dense = np.concatenate([self._dense_rows(st, k)
                                for st, k in zip(batch, sizes)])
        ids = np.concatenate([np.asarray(st.request.candidate_ids,
                                         np.int64) for st in batch])
        try:
            logits = self._forward(dense, ids)
        except Exception:
            # fault isolation: one poisoned request (bad ids, a raising
            # model) must fail ALONE — re-run each request solo so its
            # batch-mates still complete and every request lands a
            # terminal outcome (the per-slot discipline)
            self._rank_isolated(batch)
            return
        now = self.clock()
        self._t_last = now
        self._observe_phase()
        off = 0
        for st, k in zip(batch, sizes):
            self._complete(st, logits[off:off + k], now)
            off += k

    def _rank_isolated(self, batch: List[_State]) -> None:
        for st in batch:
            k = int(st.request.candidate_ids.shape[0])
            try:
                logits = self._forward(
                    self._dense_rows(st, k),
                    np.asarray(st.request.candidate_ids, np.int64))
            except Exception as e:
                st.failure = repr(e)
                self._terminate(st, "failed")
                continue
            now = self.clock()
            self._t_last = now
            self._observe_phase()
            self._complete(st, logits, now)

    def run(self, max_steps: Optional[int] = None) -> None:
        steps = 0
        while self._queue:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    # -- observability -------------------------------------------------------
    def metrics_summary(self) -> dict:
        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else None

        elapsed = (max(self._t_last - self._t_first, 1e-9)
                   if self._t_first is not None and self._t_last is not None
                   else None)
        return {
            "requests_submitted": self.stats["submitted"],
            "requests_completed": self.stats["completed"],
            "requests_expired": self.stats["expired"],
            "requests_rejected": self.stats["rejected"],
            "requests_shed": self.stats["shed"],
            "requests_failed": self.stats["failed"],
            "candidates_scored": self.stats["candidates_scored"],
            "elapsed_s": elapsed,
            "candidates_per_sec": (self.stats["candidates_scored"]
                                   / elapsed if elapsed else None),
            "e2e_p50_s": pct(self._lat["e2e"], 50),
            "e2e_p99_s": pct(self._lat["e2e"], 99),
            "lookup_p50_s": pct(self._lat["lookup"], 50),
            "lookup_p99_s": pct(self._lat["lookup"], 99),
        }


def reset_engines() -> None:
    """Test isolation: drop queued work from live engines and restart
    the request-id stream."""
    global _req_ids
    for eng in list(_LIVE_ENGINES):
        eng._queue.clear()
    _req_ids = itertools.count(1)
