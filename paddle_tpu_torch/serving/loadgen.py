"""Synthetic open-loop load generator for the serving engine.

Counterpart of ``paddle_tpu/serving/loadgen.py``: arrivals follow a
fixed, seeded schedule however fast the engine drains (the honest way
to measure serving latency), and the same :class:`LoadSpec` with the
same seed gives the JAX package's schedule byte for byte: arrival
times, prompts, token budgets, tenants and adapters.

Arrivals are Poisson (exponential gaps at ``rate_rps``). Chat-style
shared prefixes (``shared_prefix_len``) open every prompt with one of
``prefix_pool_size`` fixed prefixes drawn with bounded-zipf reuse; with
``tenants`` each tenant owns its own prefix pool, and ``adapter_pool``
stamps each request with its tenant and one of that tenant's adapters
(``tenant{t}/adapter{k}``), drawn from a side generator so that arming
it changes none of the other draws.

Not ported: the gamma and MMPP arrival processes, deadlines, priorities
and lifecycle tags (the port's ``Request`` has none of them), the
client-side token bucket and ``run_fleet_open_loop`` (the port has no
fleet router yet). The port has no decode watchdog, so
``watchdog_trips`` is always 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .sampling import SamplingParams
from .scheduler import Request, ServerOverloaded

__all__ = ["LoadSpec", "build_requests", "run_open_loop"]

@dataclass
class LoadSpec:
    num_requests: int = 16
    rate_rps: float = 4.0
    prompt_len_range: Tuple[int, int] = (16, 64)
    max_new_range: Tuple[int, int] = (8, 32)
    vocab_size: int = 50304
    seed: int = 0
    sampling: Optional[SamplingParams] = None
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


def _zipf_cdf(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64),
                       float(exponent))
    return np.cumsum(w / w.sum())


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
    arrivals = np.cumsum(rng.exponential(1.0 / max(spec.rate_rps, 1e-9),
                                         spec.num_requests))
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
        req = Request(prompt,
                      max_new_tokens=int(rng.integers(lo_n, hi_n + 1)),
                      sampling=spec.sampling or SamplingParams(),
                      tenant=tenant, adapter=adapter)
        out.append((float(arrivals[i]), req))
    return out


def run_open_loop(engine, spec: LoadSpec) -> dict:
    """Drive ``engine`` through the schedule of ``spec`` on the host
    clock and return ``engine.metrics_summary()`` with the offered load
    and the requests the engine refused (``ServerOverloaded``, counted,
    not raised)."""
    schedule = build_requests(spec)
    t0 = time.perf_counter()
    i = 0
    rejected = 0
    while i < len(schedule) or engine.scheduler.has_work:
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            try:
                engine.submit(schedule[i][1])
            except ServerOverloaded:
                rejected += 1
            i += 1
        if engine.scheduler.has_work:
            engine.step()
        elif i < len(schedule):
            # idle until the next arrival
            wait = schedule[i][0] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    summary = engine.metrics_summary()
    summary["offered_rate_rps"] = spec.rate_rps
    summary["num_requests"] = spec.num_requests
    summary["requests_rejected"] = rejected
    summary["watchdog_trips"] = 0
    return summary
