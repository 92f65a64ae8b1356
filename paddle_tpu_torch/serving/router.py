"""Fleet front-end: prefix-affine routing over N serving replicas with
migration that loses no request, PyTorch port.

Counterpart of ``paddle_tpu/serving/router.py``. One
:class:`~.engine.ServingEngine` is one host; the router makes N engines
act as one service:

- **placement** is prefix-affine: a request consistent-hashes on its
  leading KV-page token key (``np.int64`` tokens of the first
  ``affinity_blocks`` pages, blake2b with an 8-byte digest, the JAX
  package's bytes), so a shared-prefix family stays on one replica and
  its radix cache keeps hitting at fleet scale;
- **balancing** reads the engines' own readiness and status providers
  (what ``/readyz`` and ``/statusz`` serve): a draining, shedding or
  watchdog-tripped replica takes no new traffic, and a saturated affine
  replica (queue depth, free-page floor) falls back to
  power-of-two-choices over the ready ones;
- **migration**: a graceful drain snapshots undone work and the router
  resubmits it on survivors by the same affinity; a replica death has
  no engine to cooperate, so the router rebuilds each in-flight request
  from its OWN stream records (original prompt and the tokens streamed
  so far) through the same ``requests_from_snapshot`` restore. Either
  way a greedy continuation is token-exact and no request id is lost or
  duplicated.

Driving: :meth:`FleetRouter.run` steps the replicas round-robin in the
calling thread; :meth:`FleetRouter.start` runs one serve thread per
replica. On one card the replicas' dispatches share the device, and
each serve thread enters no-grad mode and the starting thread's CUDA
stream itself (both are per thread). :meth:`FleetRouter.summary`'s
``aggregate_tokens_per_sec`` divides by the busiest replica's busy
seconds, the JAX package's model of replicas on separate hosts; on one
card it is that model, not a measured rate.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..monitor import get_registry
from ..monitor import trace as _trace
from ..monitor.flight_recorder import safe_record_event
from .resilience import (ServerOverloaded, load_drain_snapshot,
                         requests_from_snapshot)
from .sampling import SamplingParams
from .scheduler import Request

__all__ = ["FleetRouter", "ReplicaHandle", "RouterConfig"]

#: engine outcomes the router treats as terminal for its own records
#: ("drained" is NOT here: it means the work moved to a snapshot and a
#: migration is re-homing it)
_TERMINAL_OUTCOMES = ("completed", "failed", "cancelled", "expired",
                      "shed")


class ReplicaHandle:
    """One serving replica as the router sees it: a name, a submit/step
    surface behind a lock (an engine is single-threaded), and the SAME
    readiness/status data its telemetry plane serves on ``/readyz`` and
    ``/statusz``."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.alive = True
        self.lock = threading.RLock()
        #: wall time spent inside step(): the per-host busy-time model
        #: summary() aggregates over (in-process replicas share one
        #: interpreter, and here one card, so per-replica busy seconds,
        #: not router wall time, is what would map to fleet wall time on
        #: separate hosts)
        self.busy_s = 0.0
        self.last_error: Optional[BaseException] = None

    def readiness(self) -> Optional[dict]:
        """None = ready (the /readyz contract); a dead replica reports
        itself the way a connection-refused poll would."""
        if not self.alive:
            return {"state": "dead"}
        return self.engine._readiness()

    def status(self) -> dict:
        """The load-relevant slice of /statusz."""
        sched = self.engine.scheduler
        return {"queue_depth": sched.queue_depth,
                "active_slots": sum(1 for s in sched.slots
                                    if s is not None),
                "free_pages": self.engine.cache.allocator.free_pages}

    def submit(self, request: Request):
        with self.lock:
            return self.engine.submit(request)

    def step(self) -> None:
        with self.lock:
            if not self.alive or not self.engine.scheduler.has_work:
                return
            t0 = time.perf_counter()
            try:
                self.engine.step()
            finally:
                self.busy_s += time.perf_counter() - t0


@dataclass
class RouterConfig:
    """Routing policy knobs."""

    #: leading KV pages of the prompt hashed as the affinity key —
    #: prompts sharing their first ``affinity_blocks`` pages land on
    #: the same replica (and therefore the same radix tree)
    affinity_blocks: int = 1
    #: ring points per replica (more = smoother key spread)
    virtual_nodes: int = 64
    #: affine replica overflows to power-of-two-choices past this
    #: queue depth ...
    saturation_queue_depth: int = 4
    #: ... or when its free KV pages drop to this floor
    saturation_free_pages: int = 0
    #: root for migration drain snapshots (per-replica subdirs); None =
    #: a tempdir is created on first graceful drain
    drain_dir: Optional[str] = None
    seed: int = 0


@dataclass
class _RouterRecord:
    """The router's own durable view of one fleet request — enough to
    rebuild its undone work WITHOUT the owning engine's cooperation
    (the replica-death path)."""

    request_id: int                     # fleet identity (first submit)
    prompt: List[int]                   # ORIGINAL prompt tokens
    max_new_tokens: int
    sampling: SamplingParams
    eos_token_id: Optional[int]
    priority: int
    client_on_token: Optional[Callable]
    client_stop: Optional[Callable]
    replica: str
    tokens: List[int] = field(default_factory=list)   # streamed so far
    trace_id: Optional[str] = None
    trace: object = None                # live fleet.request Trace, if any
    trace_parent: Optional[str] = None  # last propagated parent token
    hops: int = 0                       # migrations survived
    done: bool = False
    outcome: Optional[str] = None
    state: object = None                # live RequestState, if any
    #: split-arm tag while a TrafficSplit is armed:
    #: "baseline" | "candidate" | "shadow"; None outside a bake —
    #: records without an arm emit no arm metrics (flags-off pin)
    arm: Optional[str] = None
    t_submit: float = 0.0
    #: for shadow mirrors: the primary record's request_id (greedy
    #: divergence compares the two token streams)
    shadow_of: Optional[int] = None


class FleetRouter:
    """Prefix-affine, telemetry-driven front-end over named replicas.

    ``replicas`` maps name → live :class:`~.engine.ServingEngine`.
    Synchronous driving (:meth:`run`, deterministic — chaos drills and
    chip_smoke.py use it) and threaded driving (:meth:`start` /
    :meth:`join` / :meth:`stop`, one serve thread per replica) share
    the same routing and migration paths.
    """

    def __init__(self, replicas: Dict[str, object],
                 config: Optional[RouterConfig] = None,
                 clock=time.perf_counter):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.config = config or RouterConfig()
        self.clock = clock
        self.replicas: Dict[str, ReplicaHandle] = {
            name: ReplicaHandle(name, eng)
            for name, eng in replicas.items()}
        block_sizes = {h.engine.config.block_size
                       for h in self.replicas.values()}
        if len(block_sizes) != 1:
            raise ValueError(
                f"replicas disagree on block_size ({sorted(block_sizes)}); "
                "the affinity key is page-aligned and must mean the same "
                "thing fleet-wide")
        self.block_size = block_sizes.pop()
        # consistent-hash ring: virtual_nodes points per replica, built
        # once — membership changes (death/drain) are handled by
        # SKIPPING not-ready owners while walking the ring, so the keys
        # of healthy replicas never re-shuffle when one dies
        ring = []
        for name in self.replicas:
            for v in range(self.config.virtual_nodes):
                ring.append((self._hash(f"{name}#{v}".encode()), name))
        ring.sort()
        self._ring_keys = [h for h, _ in ring]
        self._ring_names = [n for _, n in ring]
        self._records: Dict[int, _RouterRecord] = {}
        self._rng = np.random.default_rng(self.config.seed ^ 0xF1EE7)
        self._route_lat: List[float] = []
        self._stats = {"routed_affine": 0, "routed_balanced": 0,
                       "rejected": 0, "migrated_drain": 0,
                       "migrated_death": 0, "migration_failed": 0,
                       "shadow_mirrored": 0, "shadow_divergence": 0}
        # shadow/A-B traffic splitting: flag read once — off
        # ⇒ set_traffic_split raises, _split stays None forever and
        # submit's only new cost is one None check (flags-off pin)
        from ..core.flags import get_flag
        self._split_enabled = bool(get_flag("serve_traffic_split"))
        self._split = None
        self._lifecycle = None
        #: shadow mirrors live OUTSIDE _records: discarded traffic must
        #: never count toward fleet availability or duplicate ids
        self._shadow_records: Dict[int, _RouterRecord] = {}
        self._divergence_pending: List[int] = []
        self._lock = threading.RLock()
        self._threads: List[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._tmp_drain_dir: Optional[str] = None
        # fleet observability plane: ONE flag read when off; when on,
        # attach this router so the federated /statusz table carries the
        # authoritative per-replica view
        from ..monitor import fleet as _fleet
        fed = _fleet.maybe_start_from_flags()
        if fed is not None and fed.router is None:
            fed.router = self

    # -- placement ----------------------------------------------------------
    @staticmethod
    def _hash(data: bytes) -> int:
        return int.from_bytes(
            hashlib.blake2b(data, digest_size=8).digest(), "big")

    def _affinity_key(self, prompt) -> bytes:
        """The shared-prefix token key: the first ``affinity_blocks``
        KV pages' worth of prompt tokens. Page-aligned on purpose —
        radix-cache reuse is page-granular, so two prompts that would
        share cached pages hash identically."""
        n = self.block_size * self.config.affinity_blocks
        toks = np.asarray(prompt, np.int64).reshape(-1)[:n]
        return toks.tobytes()

    def _ready(self, rep: ReplicaHandle) -> bool:
        return rep.alive and rep.readiness() is None

    def _saturated(self, rep: ReplicaHandle) -> bool:
        s = rep.status()
        return (s["queue_depth"] >= self.config.saturation_queue_depth
                or s["free_pages"] <= self.config.saturation_free_pages)

    def _load(self, rep: ReplicaHandle):
        s = rep.status()
        return (s["queue_depth"] + s["active_slots"], -s["free_pages"])

    def _affine_replica(self, prompt) -> Optional[ReplicaHandle]:
        """Walk the ring clockwise from the key's position; first READY
        owner wins (dead/draining owners are skipped, their keys spill
        to the next replica on the ring — classic consistent hashing)."""
        key = self._hash(self._affinity_key(prompt))
        start = bisect.bisect_right(self._ring_keys, key)
        seen = set()
        for i in range(len(self._ring_names)):
            name = self._ring_names[(start + i) % len(self._ring_names)]
            if name in seen:
                continue
            seen.add(name)
            rep = self.replicas[name]
            if self._ready(rep):
                return rep
        return None

    def _route(self, prompt, info: Optional[dict] = None,
               exclude: Optional[str] = None) -> Optional[ReplicaHandle]:
        affine = self._affine_replica(prompt)
        if affine is not None and affine.name == exclude:
            # baseline-arm traffic keeps off the candidate replica
            # during a bake; its keys spill like a not-ready owner's
            affine = None
        if info is not None:       # tracing-only route-decision detail
            info["affinity_key"] = \
                f"{self._hash(self._affinity_key(prompt)):016x}"
        if affine is not None and not self._saturated(affine):
            self._stats["routed_affine"] += 1
            get_registry().counter(
                "serve_router_requests_total",
                "requests placed by the fleet router, by route "
                "kind").inc(route="affine")
            if info is not None:
                info["route"] = "affine"
            return affine
        if info is not None:
            info["route"] = "balanced"
            if affine is not None:
                info["fallback"] = "saturation"
        ready = [r for r in self.replicas.values()
                 if self._ready(r) and r.name != exclude]
        if not ready and exclude is not None:
            # fail open: an excluded candidate beats a shed request
            ready = [r for r in self.replicas.values() if self._ready(r)]
        if not ready:
            return None
        if len(ready) == 1:
            pick = ready[0]
        else:
            # power-of-two-choices: two distinct random candidates,
            # least-loaded wins — near-optimal balance at O(1) cost
            i, j = self._rng.choice(len(ready), size=2, replace=False)
            a, b = ready[int(i)], ready[int(j)]
            pick = a if self._load(a) <= self._load(b) else b
        self._stats["routed_balanced"] += 1
        get_registry().counter(
            "serve_router_requests_total",
            "requests placed by the fleet router, by route "
            "kind").inc(route="balanced")
        return pick

    # -- shadow/A-B traffic splitting ---------------------------------------
    def replica(self, name: str) -> Optional[ReplicaHandle]:
        return self.replicas.get(name)

    def attach_lifecycle(self, controller) -> None:
        """Wire a :class:`~.lifecycle.LifecycleController`: the sweep
        reports terminal split-arm outcomes to it and :meth:`step_all`
        ticks its bake decision after each pass."""
        self._lifecycle = controller

    def set_traffic_split(self, split) -> None:
        """Arm a :class:`~.lifecycle.TrafficSplit`: live traffic
        hash-splits between the baseline replicas and the candidate
        (``ab_frac``) and/or mirrors onto the candidate with the
        mirror's response discarded but fully measured
        (``shadow_frac``). Requires ``FLAGS_serve_traffic_split`` (read
        once at router construction)."""
        if not self._split_enabled:
            raise RuntimeError(
                "FLAGS_serve_traffic_split is off — traffic splitting "
                "is disarmed for this router (the flag is read once at "
                "construction)")
        if split.candidate not in self.replicas:
            raise ValueError(
                f"traffic split candidate {split.candidate!r} is not a "
                f"replica ({sorted(self.replicas)})")
        self._split = split
        safe_record_event("traffic_split_set",
                          candidate=split.candidate,
                          ab_frac=split.ab_frac,
                          shadow_frac=split.shadow_frac)

    def clear_traffic_split(self) -> None:
        if self._split is not None:
            safe_record_event("traffic_split_cleared",
                              candidate=self._split.candidate)
        self._split = None

    def _mirror_shadow(self, rec: _RouterRecord, request: Request,
                       split) -> None:
        """Submit a shadow copy of a just-placed baseline request to
        the candidate replica. The mirror has no client callbacks (its
        response is discarded), its own request id, and its own record
        OUTSIDE the availability books; a refusal drops the mirror
        silently — shadow load must never shed live traffic."""
        cand = self.replicas.get(split.candidate)
        if cand is None or not self._ready(cand):
            return
        mirror = Request(
            prompt=np.asarray(rec.prompt, np.int32),
            max_new_tokens=rec.max_new_tokens,
            sampling=request.sampling,
            eos_token_id=request.eos_token_id,
            priority=request.priority,
            deadline_s=request.deadline_s,
            tenant=request.tenant,
            adapter=request.adapter)
        srec = _RouterRecord(
            request_id=int(mirror.request_id),
            prompt=list(rec.prompt),
            max_new_tokens=rec.max_new_tokens,
            sampling=request.sampling,
            eos_token_id=request.eos_token_id,
            priority=int(request.priority),
            client_on_token=None, client_stop=None,
            replica=cand.name, arm="shadow",
            t_submit=self.clock(), shadow_of=rec.request_id)
        mirror.on_token = self._tee(srec)
        try:
            srec.state = cand.submit(mirror)
        except (ServerOverloaded, ValueError):
            return
        with self._lock:
            self._shadow_records[srec.request_id] = srec
            self._stats["shadow_mirrored"] += 1

    def _observe_arm(self, rec: _RouterRecord, now: float) -> None:
        """Per-arm accounting for one terminal record (only called on
        arm-tagged records, so an un-split fleet emits none of these
        series)."""
        reg = get_registry()
        reg.counter(
            "serve_arm_requests_total",
            "terminal split-arm outcomes during a lifecycle "
            "bake").inc(arm=rec.arm, event=rec.outcome)
        e2e = (now - rec.t_submit) if rec.t_submit else None
        if e2e is not None:
            reg.histogram(
                "serve_arm_e2e_seconds",
                "split-arm end-to-end latency (submit -> "
                "terminal)").observe(e2e, arm=rec.arm)
        if self._lifecycle is not None:
            self._lifecycle.observe(rec.arm, rec.outcome, e2e, t=now)

    def _check_divergence(self, srec: _RouterRecord) -> bool:
        """Compare a terminal shadow mirror against its primary; True
        when settled (primary terminal too, or gone). Only greedy
        completed pairs count — sampled arms diverge by construction."""
        primary = self._records.get(srec.shadow_of)
        if primary is None:
            return True
        if not primary.done:
            return False
        if (srec.outcome == "completed"
                and primary.outcome == "completed"
                and srec.sampling.temperature == 0.0
                and srec.tokens != primary.tokens):
            self._stats["shadow_divergence"] += 1
            get_registry().counter(
                "serve_shadow_divergence_total",
                "greedy shadow mirrors whose token stream diverged "
                "from their primary's").inc()
            safe_record_event("shadow_divergence",
                              request_id=primary.request_id,
                              shadow_id=srec.request_id,
                              primary_tokens=len(primary.tokens),
                              shadow_tokens=len(srec.tokens))
        return True

    # -- submission ---------------------------------------------------------
    def _tee(self, rec: _RouterRecord) -> Callable:
        """on_token wrapper that journals every streamed token into the
        router's record (migration-by-death replays from it) before
        forwarding to the client's callback."""
        def on_token(req, token, text):
            rec.tokens.append(int(token))
            if rec.client_on_token is not None:
                rec.client_on_token(req, token, text)
        return on_token

    def submit(self, request: Request):
        """Route + submit one request. Raises
        :class:`~.resilience.ServerOverloaded` when no ready replica
        will take it (counted — availability accounting includes
        refusals)."""
        t0 = self.clock()
        tr = route_sp = info = None
        if _trace.enabled():
            # ONE distributed trace per fleet request: the router owns
            # the root ("fleet.request"); the replica's serve.request
            # tree parents under the route (or migration-hop) span via
            # the context carried on the Request. Flags off ⇒ this
            # whole branch is a single boolean read and the fast path
            # stays allocation-free (pinned by test).
            tr = _trace.get_tracer().start_trace(
                "fleet.request", trace_id=request.trace_id, t=t0,
                process="router",
                request_id=int(request.request_id),
                tenant=request.tenant)
            route_sp = tr.start_span("route", t=t0)
            info = {}
        split = self._split
        arm = None
        if split is not None:
            from .lifecycle import assign_arm, should_shadow
            arm = assign_arm(int(request.request_id), split.seed,
                             split.ab_frac)
        if arm == "candidate":
            # the A/B arm lives on the candidate replica; a not-ready
            # candidate fails open to the baseline (availability first)
            cand = self.replicas.get(split.candidate)
            if cand is not None and self._ready(cand):
                rep = cand
                if info is not None:
                    info["route"] = "ab_candidate"
            else:
                arm = "baseline"
                rep = self._route(request.prompt, info,
                                  exclude=split.candidate)
        elif arm == "baseline":
            rep = self._route(request.prompt, info,
                              exclude=split.candidate)
        else:
            rep = self._route(request.prompt, info)
        dt = self.clock() - t0
        self._route_lat.append(dt)
        get_registry().histogram(
            "serve_router_route_seconds",
            "fleet route-decision wall time").observe(dt)
        if rep is None:
            if tr is not None:
                tr.end_span(route_sp, t=t0 + dt, **info)
                tr.mark_anomaly("shed", reject="no ready replica")
                _trace.get_tracer().finish_trace(tr)
            self._reject()
            raise ServerOverloaded("no ready replica")
        if tr is not None:
            tr.end_span(route_sp, t=t0 + dt, replica=rep.name, **info)
            request.trace_id = tr.trace_id
            request.trace_parent = tr.context_for(route_sp)
            request.trace_process = rep.name
            request.trace_sampled = tr.head_sampled
        rec = _RouterRecord(
            request_id=int(request.request_id),
            prompt=[int(t) for t in
                    np.asarray(request.prompt).reshape(-1)],
            max_new_tokens=int(request.max_new_tokens),
            sampling=request.sampling,
            eos_token_id=request.eos_token_id,
            priority=int(request.priority),
            client_on_token=request.on_token,
            client_stop=request.stop,
            replica=rep.name, arm=arm, t_submit=t0,
            trace=tr, trace_parent=request.trace_parent)
        request.on_token = self._tee(rec)
        try:
            st = rep.submit(request)
        except ServerOverloaded:
            # the chosen replica refused at its own door (bounded
            # queue / overload detector): try every other ready
            # replica least-loaded-first before giving up
            for other in sorted(
                    (r for r in self.replicas.values()
                     if r is not rep and self._ready(r)),
                    key=self._load):
                try:
                    if tr is not None:
                        request.trace_process = other.name
                    st = other.submit(request)
                    if tr is not None:
                        tr.event("overflow", from_replica=rep.name,
                                 to_replica=other.name)
                    rep = other
                    break
                except ServerOverloaded:
                    continue
            else:
                if tr is not None:
                    tr.mark_anomaly("shed",
                                    reject="all replicas overloaded")
                    _trace.get_tracer().finish_trace(tr)
                self._reject()
                raise
        rec.replica = rep.name
        rec.state = st
        st_tr = getattr(st, "trace", None)
        rec.trace_id = (st_tr.trace_id if st_tr is not None
                        else request.trace_id)
        with self._lock:
            self._records[rec.request_id] = rec
        if (arm == "baseline" and split.shadow_frac > 0.0
                and rep.name != split.candidate
                and should_shadow(rec.request_id, split.seed,
                                  split.shadow_frac)):
            self._mirror_shadow(rec, request, split)
        return rec

    def _reject(self) -> None:
        with self._lock:
            self._stats["rejected"] += 1
        get_registry().counter(
            "serve_router_rejected_total",
            "requests the router could not place on any ready "
            "replica").inc()

    # -- migration ----------------------------------------------------------
    def _migration_dir(self, name: str) -> str:
        import os
        root = self.config.drain_dir
        if root is None:
            if self._tmp_drain_dir is None:
                import tempfile
                self._tmp_drain_dir = tempfile.mkdtemp(
                    prefix="ptpu_router_drain_")
            root = self._tmp_drain_dir
        return os.path.join(root, name)

    def _resubmit(self, rec: _RouterRecord, request: Request,
                  reason: str) -> bool:
        """Re-home one migrated request: affinity keyed on the ORIGINAL
        prompt (the family's radix tree, not the grown continuation),
        streaming continues into the same record, trace identity
        survives."""
        rec.state = None
        tr = rec.trace
        hop = (tr.start_span("migrate", reason=reason,
                             from_replica=rec.replica,
                             hop=rec.hops + 1,
                             tokens_streamed=len(rec.tokens))
               if tr is not None else None)
        target = self._affine_replica(rec.prompt)
        if target is None or self._saturated(target):
            picked = self._route(rec.prompt)
            target = picked if picked is not None else target
        if target is None:
            if hop is not None:
                tr.end_span(hop, outcome="failed",
                            reject="no ready replica")
            rec.done = True
            rec.outcome = "failed"
            self._stats["migration_failed"] += 1
            return False
        request.on_token = self._tee(rec)
        request.stop = rec.client_stop
        if hop is not None:
            # each hop re-parents the continuation: the survivor's
            # serve.request tree hangs off THIS migration span
            request.trace_id = tr.trace_id
            request.trace_parent = tr.context_for(hop)
            request.trace_process = target.name
            request.trace_sampled = tr.head_sampled
            rec.trace_parent = request.trace_parent
        try:
            st = target.submit(request)
        except ServerOverloaded:
            if hop is not None:
                tr.end_span(hop, outcome="failed",
                            to_replica=target.name,
                            reject="target overloaded")
            rec.done = True
            rec.outcome = "failed"
            self._stats["migration_failed"] += 1
            return False
        if hop is not None:
            tr.end_span(hop, to_replica=target.name)
        rec.replica = target.name
        rec.state = st
        rec.hops += 1
        self._stats[f"migrated_{reason}"] += 1
        get_registry().counter(
            "serve_router_migrations_total",
            "in-flight requests re-homed onto a surviving replica, by "
            "cause").inc(reason=reason)
        safe_record_event("replica_migration", reason=reason,
                          request_id=rec.request_id,
                          to_replica=target.name, hops=rec.hops,
                          tokens_streamed=len(rec.tokens))
        return True

    def drain_replica(self, name: str,
                      budget_s: Optional[float] = None) -> dict:
        """Graceful hand-off: the engine's drain finishes what it
        can inside the budget and snapshots the rest (mid-chunk prefill
        progress, trace_ids and all); the router restores the snapshot
        through ``requests_from_snapshot`` and re-homes every spec on a
        survivor. The drained replica stays alive-but-draining (its
        /readyz already says so), taking no new traffic."""
        rep = self.replicas[name]
        snap_dir = self._migration_dir(name)
        with rep.lock:
            report = rep.engine.drain(snapshot_dir=snap_dir,
                                      budget_s=budget_s)
        moved = 0
        if report.snapshotted:
            _, specs = load_drain_snapshot(snap_dir)
            with self._lock:
                by_cur_id = {}
                for rec in self._records.values():
                    st = rec.state
                    if rec.replica == name and st is not None:
                        by_cur_id[int(st.request.request_id)] = rec
                for spec in specs:
                    rec = by_cur_id.get(int(spec["request_id"]))
                    if rec is None or rec.done:
                        continue
                    reqs = requests_from_snapshot([spec])
                    if not reqs:
                        continue
                    if self._resubmit(rec, reqs[0], reason="drain"):
                        moved += 1
        self._sweep()
        return {"replica": name, "completed": report.completed,
                "snapshotted": report.snapshotted, "migrated": moved}

    def kill_replica(self, name: str) -> int:
        """Simulated replica death (the chaos drill): NO cooperation
        from the dying engine — the router rebuilds each in-flight
        request's spec from its own streaming journal (original prompt
        + tokens already streamed to the client) and restores it
        through the same ``requests_from_snapshot`` path the drain
        uses. Committed tokens were streamed, so the continuation is
        token-exact; uncommitted work (mid-chunk prefill, staged
        drafts) recomputes on the survivor. Returns how many requests
        migrated."""
        rep = self.replicas[name]
        rep.alive = False
        with rep.lock:                   # wait out any in-flight step
            rep.engine.shutdown()        # post-mortem cleanup only
        moved = 0
        with self._lock:
            for rec in list(self._records.values()):
                if rec.replica != name or rec.done:
                    continue
                if (rec.eos_token_id is not None
                        and rec.eos_token_id in rec.tokens):
                    # the stream already ended (eos was streamed):
                    # nothing undone, just close the record
                    rec.done = True
                    rec.outcome = "completed"
                    rec.state = None
                    continue
                spec = {
                    "request_id": rec.request_id,
                    "prompt": list(rec.prompt),
                    "generated": list(rec.tokens),
                    "max_new_tokens": rec.max_new_tokens,
                    "sampling": {
                        "temperature": rec.sampling.temperature,
                        "top_k": rec.sampling.top_k,
                        "top_p": rec.sampling.top_p},
                    "eos_token_id": rec.eos_token_id,
                    "priority": rec.priority,
                }
                if rec.trace_id is not None:
                    spec["trace_id"] = rec.trace_id
                if rec.trace_parent is not None:
                    # keep the fleet parent link across the journal
                    # round-trip (the drain path carries it inside the
                    # engine snapshot already)
                    spec["trace_parent"] = rec.trace_parent
                reqs = requests_from_snapshot([spec])
                if not reqs:
                    # budget exhausted before the death: completed
                    rec.done = True
                    rec.outcome = "completed"
                    rec.state = None
                    continue
                if self._resubmit(rec, reqs[0], reason="death"):
                    moved += 1
        return moved

    # -- driving ------------------------------------------------------------
    def _sweep(self) -> None:
        """Fold engine-side completions into the router's records,
        close each finished record's fleet trace (terminal failures
        tail-retain it), and refresh the fleet gauges."""
        now = self.clock()
        with self._lock:
            for rec in self._records.values():
                st = rec.state
                if not rec.done and st is not None \
                        and st.outcome in _TERMINAL_OUTCOMES:
                    rec.done = True
                    rec.outcome = st.outcome
                    rec.state = None
                    if rec.arm is not None:
                        self._observe_arm(rec, now)
                if rec.done and rec.trace is not None:
                    tr = rec.trace
                    rec.trace = None
                    tr.root.set_attrs(outcome=rec.outcome, hops=rec.hops)
                    if rec.outcome in _trace.ANOMALY_REASONS:
                        tr.mark_anomaly(rec.outcome)
                    _trace.get_tracer().finish_trace(tr)
            # shadow mirrors fold the same way but into their own
            # books; a terminal mirror whose primary is still in
            # flight re-checks divergence on later sweeps
            for sid, srec in self._shadow_records.items():
                st = srec.state
                if not srec.done and st is not None \
                        and st.outcome in _TERMINAL_OUTCOMES:
                    srec.done = True
                    srec.outcome = st.outcome
                    srec.state = None
                    self._observe_arm(srec, now)
                    if not self._check_divergence(srec):
                        self._divergence_pending.append(sid)
            if self._divergence_pending:
                self._divergence_pending = [
                    sid for sid in self._divergence_pending
                    if not self._check_divergence(
                        self._shadow_records[sid])]

    def step_all(self) -> bool:
        """One synchronous round-robin pass over the live replicas.
        Returns whether any replica had work (False = fleet idle)."""
        worked = False
        for rep in self.replicas.values():
            if rep.alive and rep.engine.scheduler.has_work:
                rep.step()
                worked = True
        self._sweep()
        if self._lifecycle is not None:
            # bake-decision tick outside the record lock: a decision
            # touches replica engines (rollback/promotion swaps)
            self._lifecycle.maybe_decide()
        return worked

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive the fleet in the calling thread until idle
        (deterministic: drills and chip_smoke.py use this mode)."""
        steps = 0
        while self.step_all():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None) -> List[np.ndarray]:
        """Batch convenience mirroring ``ServingEngine.generate``, but
        fleet-routed: submit all, run to idle, return full sequences
        (prompt + streamed tokens) in submission order — migration-
        transparent, because the router's journal IS the stream."""
        recs = [self.submit(Request(
            p, max_new_tokens=max_new_tokens,
            sampling=sampling or SamplingParams(),
            eos_token_id=eos_token_id)) for p in prompts]
        self.run()
        return [np.asarray(rec.prompt + rec.tokens, np.int32)
                for rec in recs]

    def start(self) -> None:
        """Threaded driving: one serve loop per replica (each engine
        stays single-threaded behind its handle lock). Each loop runs
        without grad and, for an engine on the card, on this thread's
        current CUDA stream of that device (grad mode and the current
        stream are per thread)."""
        if self._threads:
            return
        self._stop_evt.clear()
        for rep in self.replicas.values():
            dev = rep.engine.device
            stream = (torch.cuda.current_stream(dev)
                      if dev.type == "cuda" else None)
            t = threading.Thread(target=self._serve_loop,
                                 args=(rep, stream),
                                 name=f"ptpu-replica-{rep.name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_loop(self, rep: ReplicaHandle, stream=None) -> None:
        with torch.no_grad(), (torch.cuda.stream(stream)
                               if stream is not None
                               else contextlib.nullcontext()):
            while not self._stop_evt.is_set():
                if rep.alive and rep.engine.scheduler.has_work:
                    try:
                        rep.step()
                    except Exception as e:      # noqa: BLE001
                        # a replica's failure must never take the router's
                        # threads down; the engine's own fault isolation
                        # and readiness reporting cover the rest
                        rep.last_error = e
                    self._sweep()
                else:
                    self._stop_evt.wait(0.002)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until the fleet is idle (threaded mode). Returns False
        on timeout."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while any(r.alive and r.engine.scheduler.has_work
                  for r in self.replicas.values()):
            if deadline is not None and time.perf_counter() > deadline:
                return False
            time.sleep(0.002)
        self._sweep()
        return True

    def stop(self) -> None:
        self._stop_evt.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    # -- observability ------------------------------------------------------
    def _publish_fleet_gauges(self) -> None:
        reg = get_registry()
        ready = alive = 0
        for name, rep in self.replicas.items():
            if rep.alive:
                alive += 1
                if self._ready(rep):
                    ready += 1
                s = rep.status()
                ms = rep.engine.metrics_summary()
                reg.gauge(
                    "serve_router_replica_queue_depth",
                    "per-replica waiting-queue depth as the router "
                    "sees it").set(s["queue_depth"], replica=name)
                reg.gauge(
                    "serve_router_replica_prefix_hit_pct",
                    "per-replica radix prefix-cache hit percentage"
                ).set(ms.get("prefix_hit_pct") or 0.0, replica=name)
                reg.gauge(
                    "serve_router_replica_shed_requests",
                    "per-replica cumulative shed count").set(
                    rep.engine.scheduler.stats.get("shed", 0),
                    replica=name)
        reg.gauge("serve_router_replicas",
                  "fleet size by state").set(alive, state="alive")
        reg.gauge("serve_router_replicas",
                  "fleet size by state").set(ready, state="ready")

    def summary(self) -> dict:
        """Fleet-level rollup: aggregate throughput (per-host busy-time
        model), fleet prefix hit%, availability accounting (offered =
        completed + failed-ish + rejected; nothing dropped, nothing
        double-counted), migration and routing counters, and per-replica
        summaries."""
        self._sweep()
        self._publish_fleet_gauges()
        per = {}
        tot_tokens = 0
        hit_tokens = 0
        prefill_tokens = 0
        busy = []
        for name, rep in self.replicas.items():
            ms = rep.engine.metrics_summary()
            per[name] = {
                "alive": rep.alive,
                "busy_s": rep.busy_s,
                "tokens_generated": ms.get("tokens_generated", 0),
                "tokens_per_sec": ms.get("tokens_per_sec", 0.0),
                "prefix_hit_pct": ms.get("prefix_hit_pct", 0.0),
                "requests_completed": ms.get("requests_completed", 0),
                "shed": rep.engine.scheduler.stats.get("shed", 0),
            }
            tot_tokens += ms.get("tokens_generated", 0)
            hit_tokens += ms.get("prefix_hit_tokens", 0)
            prefill_tokens += ms.get("prefill_tokens", 0)
            if rep.busy_s > 0:
                busy.append(rep.busy_s)
        with self._lock:
            recs = list(self._records.values())
            shadow_recs = list(self._shadow_records.values())
            stats = dict(self._stats)
            lat = sorted(self._route_lat)
        arm_requests: Dict[str, int] = {}
        for r in recs:
            if r.arm is not None:
                arm_requests[r.arm] = arm_requests.get(r.arm, 0) + 1
        if shadow_recs:
            arm_requests["shadow"] = len(shadow_recs)
        completed = sum(1 for r in recs
                        if r.done and r.outcome == "completed")
        failed = sum(1 for r in recs
                     if r.done and r.outcome != "completed")
        in_flight = sum(1 for r in recs if not r.done)
        offered = len(recs) + stats["rejected"]
        ids = [r.request_id for r in recs]
        q = (lambda p: lat[min(len(lat) - 1,
                               int(p * (len(lat) - 1)))] if lat else 0.0)
        # per-host wall-time model: replicas on real hosts run
        # concurrently, so fleet wall time is the BUSIEST replica's
        # busy seconds (in-process CPU replicas serialize on the GIL;
        # summing their wall would charge the fleet for it)
        wall = max(busy) if busy else 0.0
        return {
            "replicas": per,
            "num_replicas": len(self.replicas),
            "alive_replicas": sum(1 for r in self.replicas.values()
                                  if r.alive),
            "tokens_generated": tot_tokens,
            "aggregate_tokens_per_sec": (tot_tokens / wall
                                         if wall > 0 else 0.0),
            "fleet_prefix_hit_pct": (
                100.0 * hit_tokens
                / max(1, hit_tokens + prefill_tokens)),
            "requests_offered": offered,
            "requests_completed": completed,
            "requests_failed": failed,
            "requests_rejected": stats["rejected"],
            "requests_in_flight": in_flight,
            "availability_pct": (100.0 * completed / offered
                                 if offered else 100.0),
            "duplicate_request_ids": len(ids) - len(set(ids)),
            "routed_affine": stats["routed_affine"],
            "routed_balanced": stats["routed_balanced"],
            "migrated_drain": stats["migrated_drain"],
            "migrated_death": stats["migrated_death"],
            "migration_failed": stats["migration_failed"],
            "route_overhead_p50_s": q(0.50),
            "route_overhead_p99_s": q(0.99),
            # model lifecycle ; all zero/empty off a bake
            "arm_requests": arm_requests,
            "shadow_mirrored": stats["shadow_mirrored"],
            "shadow_divergence": stats["shadow_divergence"],
            "traffic_split": (
                {"candidate": self._split.candidate,
                 "ab_frac": self._split.ab_frac,
                 "shadow_frac": self._split.shadow_frac}
                if self._split is not None else None),
        }

    def shutdown(self) -> None:
        """Stop threads and shut every live replica down."""
        self.stop()
        self._sweep()
        with self._lock:
            for rec in self._records.values():
                # close dangling fleet traces so the tracer's live map
                # never leaks (finish_trace is idempotent)
                if rec.trace is not None:
                    tr = rec.trace
                    rec.trace = None
                    _trace.get_tracer().finish_trace(tr)
        for rep in self.replicas.values():
            if rep.alive:
                rep.alive = False
                with rep.lock:
                    rep.engine.shutdown()
