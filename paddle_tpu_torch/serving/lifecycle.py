"""Zero-downtime model lifecycle: shadow/A-B validation and the
SLO-guarded promotion controller, PyTorch port.

Counterpart of ``paddle_tpu/serving/lifecycle.py``. A weight push on a
live fleet runs a state machine::

    serving -> staging -> baking -> promoted
                   \\          \\-> rolled-back
                    \\-> serving (aborted: refused push / dead replica)

``staging`` hot-swaps the candidate checkpoint onto ONE replica
(:meth:`ServingEngine.swap_weights`; a torn or mismatched push refuses
there and the push aborts with the baseline untouched). ``baking``
splits traffic through :class:`TrafficSplit`: a hash of the request id
routes an A/B fraction of live traffic to the candidate and/or mirrors a
shadow fraction (responses discarded, fully measured). The
:class:`LifecycleController` feeds every candidate-arm outcome into an
:class:`~..monitor.slo.SLOTracker` and, over the bake window, either
promotes (a rolling swap of the other replicas, one at a time) or rolls
back to the previous weights, writing an incident bundle and flight
events with the decision's inputs.

The router and the load generator tag requests through the same hash
helpers (:func:`assign_arm` / :func:`should_shadow`): the blake2b digest
of ``"{salt}:{seed}:{request_id}"``, byte for byte the JAX package's, so
a request lands in the same arm in both packages and in an offline
replay.

Everything here is behind flags (``FLAGS_serve_lifecycle`` for the
controller, ``FLAGS_serve_traffic_split`` for the router's split,
``FLAGS_serve_hot_swap`` for the engine's swap); off, none of it is
built and the serving path is unchanged.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..monitor import flight_recorder as _flight
from ..monitor import get_registry
from ..monitor.flight_recorder import safe_record_event
from ..monitor.slo import SLOTracker
from ..testing import chaos
from .engine import WeightSwapError

__all__ = ["TrafficSplit", "LifecycleConfig", "LifecycleController",
           "assign_arm", "should_shadow"]

#: lifecycle states, in gauge-code order (serve_lifecycle_state)
STATES = ("serving", "staging", "baking", "promoted", "rolled-back")

ARMS = ("baseline", "candidate", "shadow")


def _u01(salt: str, seed: int, request_id: int) -> float:
    """Uniform [0, 1) draw that is a pure function of (salt, seed,
    request id) — no RNG state, so the router, the load generator and
    an offline replay all agree on every request's assignment."""
    h = hashlib.blake2b(f"{salt}:{seed}:{request_id}".encode(),
                       digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def assign_arm(request_id: int, seed: int, candidate_frac: float) -> str:
    """Deterministic A/B split: ``"candidate"`` for ``candidate_frac``
    of request ids, ``"baseline"`` for the rest. Distinct salt from
    :func:`should_shadow` so the two decisions are independent."""
    if candidate_frac <= 0.0:
        return "baseline"
    return ("candidate"
            if _u01("ab", seed, request_id) < candidate_frac
            else "baseline")


def should_shadow(request_id: int, seed: int, shadow_frac: float) -> bool:
    """Deterministic shadow sampling: True for ``shadow_frac`` of
    request ids (the request is ALSO mirrored to the candidate)."""
    if shadow_frac <= 0.0:
        return False
    return _u01("shadow", seed, request_id) < shadow_frac


@dataclass(frozen=True)
class TrafficSplit:
    """Router traffic-split policy for one candidate bake.

    ``ab_frac`` of live traffic routes TO the candidate replica (its
    responses are served to clients — the A/B arm); ``shadow_frac`` of
    baseline traffic is ALSO mirrored to the candidate with the mirror's
    response discarded but fully measured. Both draws hash the request
    id with ``seed`` (see :func:`assign_arm` / :func:`should_shadow`),
    so assignment is deterministic and replayable."""

    candidate: str
    ab_frac: float = 0.0
    shadow_frac: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in ("ab_frac", "shadow_frac"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"TrafficSplit.{name}={v} outside [0, 1]")


@dataclass
class LifecycleConfig:
    """Promotion-controller policy knobs.

    The candidate bakes for ``bake_window_s``; during the bake ANY of
    the rollback triggers fires immediately (failure count over
    ``max_nonfinite``, availability burn over ``max_burn`` once
    ``min_requests`` candidate-arm outcomes exist, candidate p99 over
    ``max_p99_ratio`` x baseline p99). Surviving the window with at
    least ``min_requests`` outcomes promotes."""

    bake_window_s: float = 5.0
    min_requests: int = 10
    #: availability burn-rate threshold on the candidate arm (1.0 =
    #: exactly consuming budget; SRE fast-burn pages at >= 2)
    max_burn: float = 2.0
    burn_window_s: float = 5.0
    #: candidate-arm availability objective the burn is measured against
    objective: float = 0.999
    #: candidate-arm failures tolerated before instant rollback (the
    #: engine turns non-finite logits into per-request failures, so a
    #: NaN push shows up here first)
    max_nonfinite: int = 0
    #: 0 disables the latency trigger
    max_p99_ratio: float = 0.0
    #: where rollback incident bundles land (None = no bundles)
    incident_dir: Optional[str] = None


class _ArmStats:
    __slots__ = ("outcomes", "e2e")

    def __init__(self):
        self.outcomes: Dict[str, int] = {}
        self.e2e: List[float] = []

    def observe(self, outcome: str, e2e_s: Optional[float]) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        if e2e_s is not None:
            self.e2e.append(float(e2e_s))

    @property
    def total(self) -> int:
        return sum(self.outcomes.values())

    def p99(self) -> Optional[float]:
        if not self.e2e:
            return None
        xs = sorted(self.e2e)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def snapshot(self) -> dict:
        return {"outcomes": dict(self.outcomes), "total": self.total,
                "e2e_p99_s": self.p99()}


class LifecycleController:
    """Drives one weight push through the lifecycle state machine on a
    :class:`~.router.FleetRouter` fleet.

    The router reports every terminal split-arm outcome via
    :meth:`observe` (from its sweep) and ticks :meth:`maybe_decide`
    after each scheduling pass; tests and operators can also call
    :meth:`maybe_decide` directly. Constructing the controller requires
    ``FLAGS_serve_lifecycle`` (read once here) — flags off, no
    controller exists and the router never consults one."""

    def __init__(self, router, config: Optional[LifecycleConfig] = None,
                 clock=time.perf_counter):
        from ..core.flags import get_flag
        if not bool(get_flag("serve_lifecycle")):
            raise RuntimeError(
                "FLAGS_serve_lifecycle is off — the promotion "
                "controller is disarmed (the flag is read once at "
                "construction)")
        self.router = router
        self.config = config or LifecycleConfig()
        self.clock = clock
        self.state = "serving"
        self._manifest: Optional[str] = None
        self._candidate: Optional[str] = None
        self._split: Optional[TrafficSplit] = None
        self._bake_start: Optional[float] = None
        self._arms: Dict[str, _ArmStats] = {a: _ArmStats() for a in ARMS}
        self._slo: Optional[SLOTracker] = None
        self._decision: Optional[dict] = None
        self._incidents = 0
        #: the transitions taken, each with its time, epoch and detail
        self.timeline: List[dict] = []
        self._transition("serving", self.clock(), detail="attached")
        router.attach_lifecycle(self)

    # -- state machine -------------------------------------------------------
    def _transition(self, to: str, t: float, **detail) -> None:
        entry = {"t": t, "from": self.state, "to": to,
                 "epoch": self._engine_epoch(), **detail}
        self.state = to
        self.timeline.append(entry)
        reg = get_registry()
        reg.gauge(
            "serve_lifecycle_state",
            "promotion controller state (0 serving, 1 staging, 2 "
            "baking, 3 promoted, 4 rolled-back)").set(
                float(STATES.index(to)))
        reg.counter(
            "serve_lifecycle_transitions_total",
            "promotion controller state transitions").inc(to=to)
        safe_record_event("lifecycle_transition", **{
            k: v for k, v in entry.items() if k != "t"})

    def _engine_epoch(self) -> Optional[int]:
        rep = (self.router.replica(self._candidate)
               if self._candidate else None)
        return rep.engine._weights_epoch if rep is not None else None

    def begin(self, manifest_dir: str, candidate: str,
              split: Optional[TrafficSplit] = None) -> dict:
        """Stage ``manifest_dir`` onto the ``candidate`` replica and
        start the bake. A refused push (torn manifest, tree mismatch)
        or a candidate that dies mid-staging ABORTS back to ``serving``
        with the baseline untouched; otherwise the router's traffic
        split arms and the state moves to ``baking``."""
        if self.state not in ("serving", "promoted", "rolled-back"):
            raise RuntimeError(
                f"lifecycle: begin() while {self.state!r} — one push "
                "at a time")
        rep = self.router.replica(candidate)
        if rep is None or not rep.alive:
            raise ValueError(f"lifecycle: no live replica {candidate!r}")
        t = self.clock()
        self._manifest = manifest_dir
        self._candidate = candidate
        self._decision = None
        self._arms = {a: _ArmStats() for a in ARMS}
        self._transition("staging", t, manifest=manifest_dir,
                         candidate=candidate)
        try:
            rep.engine.swap_weights(manifest_dir)
        except WeightSwapError as e:
            self._transition("serving", self.clock(), aborted="refused",
                             reason=e.reason)
            safe_record_event("lifecycle_abort", reason=e.reason,
                              manifest=manifest_dir)
            return {"state": self.state, "aborted": "refused",
                    "reason": e.reason}
        if chaos.active() and chaos.probe("serve.swap.replica_die_mid_swap"):
            # the candidate died with the swap staged: migrate its
            # in-flight work (router journal resubmit) and abort — the
            # baseline arm never saw the push
            self.router.kill_replica(candidate)
            self._transition("serving", self.clock(),
                             aborted="replica_died", candidate=candidate)
            safe_record_event("lifecycle_abort", reason="replica_died",
                              candidate=candidate,
                              manifest=manifest_dir)
            return {"state": self.state, "aborted": "replica_died"}
        cfg = self.config
        self._slo = SLOTracker(
            "lifecycle_candidate", cfg.objective,
            windows=(cfg.burn_window_s,), clock=self.clock)
        self._split = split or TrafficSplit(candidate=candidate,
                                            shadow_frac=1.0)
        self.router.set_traffic_split(self._split)
        self._bake_start = self.clock()
        self._transition("baking", self._bake_start,
                         ab_frac=self._split.ab_frac,
                         shadow_frac=self._split.shadow_frac)
        return {"state": self.state, "epoch": self._engine_epoch()}

    # -- observation (fed by the router sweep) -------------------------------
    def observe(self, arm: str, outcome: str,
                e2e_s: Optional[float] = None,
                t: Optional[float] = None) -> None:
        """One terminal split-arm outcome. Candidate AND shadow
        outcomes feed the candidate SLO tracker — a shadow mirror runs
        the same candidate weights, its failures are the same signal."""
        if arm not in self._arms:
            return
        self._arms[arm].observe(outcome, e2e_s)
        if self._slo is not None and arm in ("candidate", "shadow"):
            t = self.clock() if t is None else t
            if outcome == "completed":
                self._slo.record(good=1, t=t)
            elif outcome in ("failed", "expired", "shed"):
                self._slo.record(bad=1, t=t)

    def _candidate_total(self) -> int:
        return (self._arms["candidate"].total
                + self._arms["shadow"].total)

    def _candidate_failures(self) -> int:
        return (self._arms["candidate"].outcomes.get("failed", 0)
                + self._arms["shadow"].outcomes.get("failed", 0))

    def maybe_decide(self, t: Optional[float] = None) -> Optional[str]:
        """Tick the bake: instant rollback on a tripped trigger,
        promotion once the window elapses with enough samples and no
        trigger. Returns the decision (``"promoted"``/``"rolled-back"``)
        the tick it happens, else None."""
        if self.state != "baking":
            return None
        t = self.clock() if t is None else t
        cfg = self.config
        burn = self._slo.burn_rate(cfg.burn_window_s, t=t) \
            if self._slo is not None else 0.0
        failures = self._candidate_failures()
        total = self._candidate_total()
        if failures > cfg.max_nonfinite:
            return self._rollback(t, "nonfinite", burn=burn,
                                  failures=failures)
        if total >= cfg.min_requests and burn > cfg.max_burn:
            return self._rollback(t, "slo_burn", burn=burn,
                                  failures=failures)
        if cfg.max_p99_ratio > 0.0 and total >= cfg.min_requests:
            cp = self._arms["candidate"].p99() \
                or self._arms["shadow"].p99()
            bp = self._arms["baseline"].p99()
            if cp is not None and bp and cp > cfg.max_p99_ratio * bp:
                return self._rollback(t, "latency", burn=burn,
                                      p99_ratio=cp / bp)
        if t - self._bake_start >= cfg.bake_window_s \
                and total >= cfg.min_requests:
            return self._promote(t, burn=burn)
        return None

    # -- decisions -----------------------------------------------------------
    def _decision_record(self, decision: str, t: float,
                         **detail) -> dict:
        d = {"decision": decision, "t": t,
             "manifest": self._manifest,
             "candidate": self._candidate,
             "bake_s": (t - self._bake_start
                        if self._bake_start is not None else None),
             "arms": {a: s.snapshot() for a, s in self._arms.items()},
             **detail}
        self._decision = d
        return d

    def _promote(self, t: float, **detail) -> str:
        """Roll the candidate manifest across the rest of the fleet,
        one replica at a time — a staged hot-swap never takes a replica
        out of service, and sequencing guarantees never-two-down even
        on drain-fallback swaps."""
        self.router.clear_traffic_split()
        self._split = None
        rolled = []
        cand = self.router.replica(self._candidate)
        if cand is not None and cand.alive:
            cand.engine.commit_swap()
        for rep in self.router.replicas.values():
            if rep.name == self._candidate or not rep.alive:
                continue
            info = rep.engine.swap_weights(self._manifest)
            if not info.get("pending"):
                # already cut over (idle / drain fallback): the anchor
                # tree can drop now; a still-pending swap keeps its
                # rollback anchor until the operator commits it
                rep.engine.commit_swap()
            rolled.append(rep.name)
            safe_record_event("lifecycle_replica_promoted",
                              replica=rep.name, manifest=self._manifest)
        rec = self._decision_record("promoted", t, rolled=rolled,
                                    **detail)
        self._transition("promoted", t, rolled=len(rolled), **detail)
        safe_record_event("lifecycle_promoted", manifest=self._manifest,
                          rolled=len(rolled), **detail)
        return rec["decision"]

    def _rollback(self, t: float, trigger: str, **detail) -> str:
        """Auto-rollback: tear the split down FIRST (no more traffic
        reaches the bad weights), restore the previous tree on the
        candidate, drop the bad tree, and leave the forensics — flight
        events and an incident bundle with the decision inputs."""
        self.router.clear_traffic_split()
        self._split = None
        cand = self.router.replica(self._candidate)
        if cand is not None and cand.alive:
            info = cand.engine.rollback_weights()
            if not info.get("pending"):
                cand.engine.commit_swap()     # drop the bad tree
        rec = self._decision_record("rolled-back", t, trigger=trigger,
                                    **detail)
        bundle = self._write_incident(trigger, rec)
        rec["incident"] = bundle
        self._transition("rolled-back", t, trigger=trigger, **detail)
        safe_record_event("lifecycle_rollback", trigger=trigger,
                          manifest=self._manifest, bundle=bundle,
                          **detail)
        return rec["decision"]

    def _write_incident(self, trigger: str, record: dict) -> Optional[str]:
        d = self.config.incident_dir
        if not d:
            return None
        base = os.path.join(d, f"lifecycle-{self._incidents:04d}-{trigger}")
        os.makedirs(base, exist_ok=True)
        self._incidents += 1
        with open(os.path.join(base, "incident.json"), "w") as f:
            json.dump(record, f, indent=2, sort_keys=True, default=str)
        if _flight.enabled():
            doc = _flight.get_flight_recorder().doc(
                reason=f"lifecycle_{trigger}")
            with open(os.path.join(base, "flight.json"), "w") as f:
                json.dump(doc, f, indent=2, default=str)
        return base

    # -- introspection -------------------------------------------------------
    def summary(self) -> dict:
        return {
            "state": self.state,
            "manifest": self._manifest,
            "candidate": self._candidate,
            "arms": {a: s.snapshot() for a, s in self._arms.items()},
            "burn": (self._slo.burn_rate(self.config.burn_window_s)
                     if self._slo is not None else None),
            "decision": self._decision,
            "timeline": list(self.timeline),
        }
