"""Synthetic open-loop load generator for the serving engine.

Counterpart of ``paddle_tpu/serving/loadgen.py``: arrivals follow a
fixed, seeded schedule however fast the engine drains (the honest way
to measure serving latency), and the same :class:`LoadSpec` with the
same seed gives the JAX package's schedule byte for byte: arrival
times, prompts, deadlines, priorities, token budgets, tenants and
adapters.

Arrival processes (``LoadSpec.arrival``), each at the mean rate
``rate_rps``: ``poisson`` (exponential gaps); ``gamma`` (Gamma gaps
whose squared coefficient of variation is ``burstiness``: > 1 clumps
arrivals, < 1 smooths them); ``mmpp`` (a 2-state Markov-modulated
Poisson process: a hidden state flips between a hot rate
``rate * (1 + burstiness)`` and a cold one ``rate / (1 + burstiness)``
with probability ``mmpp_switch`` per arrival, the gaps rescaled so the
mean rate stays ``rate_rps``). Chat-style
shared prefixes (``shared_prefix_len``) open every prompt with one of
``prefix_pool_size`` fixed prefixes drawn with bounded-zipf reuse; with
``tenants`` each tenant owns its own prefix pool, and ``adapter_pool``
stamps each request with its tenant and one of that tenant's adapters
(``tenant{t}/adapter{k}``), drawn from a side generator so that arming
it changes none of the other draws. ``deadline_range`` and
``priority_choices`` draw each request's ``deadline_s`` and
``priority`` from the main generator, after the prefix draws and before
the token budget, only when they are set.

:class:`TokenBucket` is client-side rate limiting:
``run_open_loop(..., token_bucket=...)`` counts arrivals over the bucket
as throttled instead of submitting them. The server's refusals
(``ServerOverloaded``) and watchdog trips (``DecodeWatchdogError``) are
counted too; a trip is retried, up to
``MAX_CONSECUTIVE_WATCHDOG_TRIPS`` in a row, and re-raised when the
dispatch is not safe to retry.

Lifecycle tags (``ab_split``, ``shadow_frac``, ``split_seed``) stamp
each request with the A/B arm and shadow decision a router under
``TrafficSplit`` would make, through the same request-id hashes
(``lifecycle.assign_arm`` / ``should_shadow``): no draw, so the other
fields stay as they were. :func:`run_fleet_open_loop` drives a
``FleetRouter`` through the same schedule.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .resilience import DecodeWatchdogError, ServerOverloaded
from .sampling import SamplingParams
from .scheduler import Request

__all__ = ["LoadSpec", "TokenBucket", "build_requests", "run_open_loop",
           "run_fleet_open_loop"]

_ARRIVALS = ("poisson", "gamma", "mmpp")

#: run_open_loop re-raises after this many watchdog trips in a row with
#: no successful step between them: a backend that hangs on every retry
#: is down, not slow
MAX_CONSECUTIVE_WATCHDOG_TRIPS = 8


@dataclass
class LoadSpec:
    num_requests: int = 16
    rate_rps: float = 4.0
    prompt_len_range: Tuple[int, int] = (16, 64)
    max_new_range: Tuple[int, int] = (8, 32)
    vocab_size: int = 50304
    seed: int = 0
    sampling: Optional[SamplingParams] = None
    #: arrival process: poisson | gamma | mmpp
    arrival: str = "poisson"
    #: gamma: squared CV of the gaps; mmpp: the hot/cold rate swing
    burstiness: float = 1.0
    #: mmpp: per-arrival probability of flipping the hidden rate state
    mmpp_switch: float = 0.1
    #: uniform per-request deadline_s sample; None = no deadlines
    deadline_range: Optional[Tuple[float, float]] = None
    #: uniform per-request priority sample; None = all priority 0
    priority_choices: Optional[Tuple[int, ...]] = None
    #: > 0: every prompt opens with one of ``prefix_pool_size`` fixed
    #: prefixes of this many tokens, drawn zipf(``prefix_zipf``)
    shared_prefix_len: int = 0
    prefix_pool_size: int = 8
    prefix_zipf: float = 1.1
    #: > 0: every request belongs to one of this many tenants, drawn
    #: zipf(``prefix_zipf``), each with its own prefix pool (needs
    #: ``shared_prefix_len > 0``)
    tenants: int = 0
    #: > 0: every tenanted request names one of this many adapters of
    #: its tenant and carries its tenant name (needs ``tenants > 0``)
    adapter_pool: int = 0
    #: > 0: stamp ``lifecycle_arm``, the A/B arm a router under
    #: ``TrafficSplit(ab_frac=ab_split, seed=split_seed)`` would place
    #: the request in (``lifecycle.assign_arm``, no draw)
    ab_split: float = 0.0
    #: > 0: stamp ``lifecycle_shadow``, whether such a router would
    #: mirror it (``lifecycle.should_shadow``)
    shadow_frac: float = 0.0
    #: the seed the tags hash with (``TrafficSplit.seed``)
    split_seed: int = 0


class TokenBucket:
    """Deterministic client-side rate limiter: ``rate`` tokens/s refill
    up to a ``burst`` cap; :meth:`admit` spends one token or answers
    False. Driven by the caller's clock values, so tests replay
    exactly."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst < 1:
            raise ValueError("token bucket needs rate > 0 and burst >= 1")
        self.rate = float(rate)
        self.capacity = float(burst)
        self.tokens = float(burst)
        self._last: Optional[float] = None

    def admit(self, now: float) -> bool:
        if self._last is not None:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def _zipf_cdf(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64),
                       float(exponent))
    return np.cumsum(w / w.sum())


def _arrival_gaps(spec: LoadSpec, rng) -> np.ndarray:
    """Inter-arrival gaps (seconds) of ``num_requests`` arrivals at the
    mean rate ``rate_rps``, in the JAX package's order of draws."""
    if spec.arrival not in _ARRIVALS:
        raise ValueError(f"unknown arrival mode {spec.arrival!r}; one "
                         f"of {_ARRIVALS}")
    mean = 1.0 / max(spec.rate_rps, 1e-9)
    n = spec.num_requests
    if spec.arrival == "gamma" and spec.burstiness <= 0.0:
        raise ValueError("gamma arrival needs burstiness > 0 "
                         "(= the squared CV of the gaps)")
    if spec.arrival == "poisson" or \
            (spec.arrival == "gamma" and spec.burstiness == 1.0):
        return rng.exponential(mean, n)
    if spec.arrival == "gamma":
        shape = 1.0 / float(spec.burstiness)
        return rng.gamma(shape, mean / shape, n)
    swing = 1.0 + max(float(spec.burstiness), 0.0)
    rates = (spec.rate_rps * swing, spec.rate_rps / swing)
    state = 0
    gaps = np.empty((n,), np.float64)
    for i in range(n):
        gaps[i] = rng.exponential(1.0 / max(rates[state], 1e-9))
        if rng.random() < spec.mmpp_switch:
            state = 1 - state
    # symmetric switching spends half the arrivals in each state, so the
    # raw mean gap is (1/swing + swing) / (2 rate): rescale to the mean
    gaps *= 2.0 / (swing + 1.0 / swing)
    return gaps


def build_requests(spec: LoadSpec) -> List[Tuple[float, Request]]:
    """``[(arrival_offset_s, Request), ...]`` sorted by arrival,
    deterministic per seed, in the JAX package's order of draws."""
    if spec.adapter_pool > 0 and spec.tenants <= 0:
        raise ValueError("adapter_pool needs tenants > 0 (adapters are "
                         "per-tenant)")
    rng = np.random.default_rng(spec.seed)
    # adapters draw from their own generator: arming adapter_pool leaves
    # every draw from ``rng`` as it was
    arng = (np.random.default_rng(spec.seed ^ 0xADA9)
            if spec.adapter_pool > 0 else None)
    arrivals = np.cumsum(_arrival_gaps(spec, rng))
    arrivals[0] = 0.0                       # the first request at t=0
    lo_p, hi_p = spec.prompt_len_range
    lo_n, hi_n = spec.max_new_range
    prefixes = prefix_cdf = None
    tenant_pools = tenant_cdf = None
    if spec.shared_prefix_len > 0 and spec.tenants > 0:
        # tenant t's pool from its own side generator
        tenant_pools = [
            np.random.default_rng(spec.seed ^ 0x5A5A ^ (0x1000 * (t + 1)))
            .integers(0, spec.vocab_size,
                      (max(1, spec.prefix_pool_size),
                       spec.shared_prefix_len)).astype(np.int32)
            for t in range(spec.tenants)]
        tenant_cdf = _zipf_cdf(spec.tenants, spec.prefix_zipf)
        prefix_cdf = _zipf_cdf(tenant_pools[0].shape[0], spec.prefix_zipf)
    elif spec.shared_prefix_len > 0:
        prefixes = np.random.default_rng(spec.seed ^ 0x5A5A).integers(
            0, spec.vocab_size,
            (max(1, spec.prefix_pool_size), spec.shared_prefix_len)
        ).astype(np.int32)
        prefix_cdf = _zipf_cdf(prefixes.shape[0], spec.prefix_zipf)
    out = []
    for i in range(spec.num_requests):
        plen = int(rng.integers(lo_p, hi_p + 1))
        prompt = rng.integers(0, spec.vocab_size, (plen,)).astype(np.int32)
        tenant = adapter = None
        if tenant_pools is not None:
            t = int(np.searchsorted(tenant_cdf, rng.random()))
            t = min(t, len(tenant_pools) - 1)
            pool = tenant_pools[t]
            pi = int(np.searchsorted(prefix_cdf, rng.random()))
            prompt = np.concatenate([pool[min(pi, len(pool) - 1)],
                                     prompt])
            if arng is not None:
                tenant = f"tenant{t}"
                adapter = (f"tenant{t}/adapter"
                           f"{int(arng.integers(0, spec.adapter_pool))}")
        elif prefixes is not None:
            pi = int(np.searchsorted(prefix_cdf, rng.random()))
            prompt = np.concatenate([prefixes[min(pi, len(prefix_cdf)
                                                  - 1)], prompt])
        deadline = None
        if spec.deadline_range is not None:
            lo_d, hi_d = spec.deadline_range
            deadline = float(rng.uniform(lo_d, hi_d))
        priority = 0
        if spec.priority_choices:
            priority = int(spec.priority_choices[
                int(rng.integers(0, len(spec.priority_choices)))])
        req = Request(prompt,
                      max_new_tokens=int(rng.integers(lo_n, hi_n + 1)),
                      sampling=spec.sampling or SamplingParams(),
                      deadline_s=deadline, priority=priority,
                      tenant=tenant, adapter=adapter)
        if spec.ab_split > 0.0 or spec.shadow_frac > 0.0:
            # request-id hashes: no draw from ``rng``, so the tags leave
            # every other field as it was
            from .lifecycle import assign_arm, should_shadow
            req.lifecycle_arm = assign_arm(
                int(req.request_id), spec.split_seed, spec.ab_split)
            req.lifecycle_shadow = should_shadow(
                int(req.request_id), spec.split_seed, spec.shadow_frac)
        out.append((float(arrivals[i]), req))
    return out


def run_open_loop(engine, spec: LoadSpec,
                  token_bucket: Optional[TokenBucket] = None) -> dict:
    """Drive ``engine`` through the schedule of ``spec`` on the host
    clock and return ``engine.metrics_summary()`` with the offered load
    and the client-visible refusals: ``requests_rejected`` (the engine's
    ``ServerOverloaded``), ``requests_throttled`` (over
    ``token_bucket``) and ``watchdog_trips``, counted, not raised."""
    schedule = build_requests(spec)
    t0 = time.perf_counter()
    i = 0
    rejected = throttled = watchdog_trips = 0
    consecutive_trips = 0
    while i < len(schedule) or engine.scheduler.has_work:
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            if token_bucket is not None and not token_bucket.admit(now):
                throttled += 1
            else:
                try:
                    engine.submit(schedule[i][1])
                except ServerOverloaded:
                    rejected += 1
            i += 1
        if engine.scheduler.has_work:
            try:
                engine.step()
                consecutive_trips = 0
            except DecodeWatchdogError as e:
                # retry the step (token-exact when retry-safe), but a
                # backend that hangs on every retry must not loop forever
                watchdog_trips += 1
                consecutive_trips += 1
                if not e.retry_safe or consecutive_trips \
                        >= MAX_CONSECUTIVE_WATCHDOG_TRIPS:
                    raise
        elif i < len(schedule):
            # idle until the next arrival
            wait = schedule[i][0] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    summary = engine.metrics_summary()
    summary["offered_rate_rps"] = spec.rate_rps
    summary["num_requests"] = spec.num_requests
    summary["requests_rejected"] = rejected
    summary["requests_throttled"] = throttled
    summary["watchdog_trips"] = watchdog_trips
    return summary


def run_fleet_open_loop(router, spec: LoadSpec) -> dict:
    """Drive a :class:`~.router.FleetRouter` through the schedule of
    ``spec`` on the host clock, as :func:`run_open_loop` drives one
    engine (the same seeded traffic): the router places each arrival
    and every live replica is stepped round-robin between arrivals.
    Router refusals (no ready replica, every replica shedding) are
    counted. Returns ``router.summary()`` with the offered load."""
    schedule = build_requests(spec)
    t0 = time.perf_counter()
    i = 0
    rejected = 0
    while i < len(schedule) or any(
            r.alive and r.engine.scheduler.has_work
            for r in router.replicas.values()):
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            try:
                router.submit(schedule[i][1])
            except ServerOverloaded:
                rejected += 1
            i += 1
        if not router.step_all() and i < len(schedule):
            wait = schedule[i][0] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    summary = router.summary()
    summary["offered_rate_rps"] = spec.rate_rps
    summary["num_requests"] = spec.num_requests
    summary["requests_rejected_router"] = rejected
    return summary
