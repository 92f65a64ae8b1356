"""Fleet observability plane: cross-replica trace merging, live
metrics federation and anomaly-triggered incident capture, PyTorch port.

Counterpart of ``paddle_tpu/monitor/fleet.py``
(``docs/OBSERVABILITY.md`` "Fleet observability"). The fleet router
scatters one request's story over processes: the routing decision in
the router's registry, the serve spans in whichever replica held the
request (another one after each migration). This module joins them, in
three layers:

- **trace merge**: :func:`merge_fleet_traces` folds per-process trace
  docs that share a ``trace_id`` into ONE span tree. Span ids are
  qualified by each doc's ``ctx`` namespace (``"<ctx>/<span_id>"``, so
  two processes' span #3 never collide), a doc whose ``parent_ctx``
  token resolves inside the group parents its root there (the join the
  router's ``Request.trace_parent`` propagation set up), and every span
  is stamped with its producing ``process``, so
  :func:`~.trace.perfetto_doc` renders one track per process.

- **metrics federation**: :class:`FleetFederator` runs a stdlib scrape
  loop over :class:`FleetTarget`\\ s (replica ``/metrics`` URLs, or
  callables for in-process fleets), parses each page with
  :func:`~.timeseries.parse_prometheus`, stamps every sample with a
  ``host`` label and REBUILDS the fleet registry from scratch each
  scrape (cumulative pages re-merged into a persistent registry would
  double-count; a rebuild makes the federated page exactly the sum of
  the per-replica pages). The fleet registry feeds a
  :class:`~.timeseries.TimeseriesRing` and an embedded
  :class:`~.server.AdminServer`: ``/metrics`` (lint-clean,
  host-labelled), ``/statusz`` (per-replica table and per-tenant
  rollup), ``/healthz``, ``/readyz`` (quorum of replica readiness) and
  ``/debug/trace`` (the MERGED fleet trace view).

- **SLO burn and incident capture**: an optional
  :class:`~.slo.SLOTracker` is fed from the federated
  ``serve_requests_total{host,event}`` deltas (a restarted replica's
  counters shrink nothing). When a multiwindow burn alert fires, or a
  tail-retained anomaly trace lands (:data:`~.trace.TRACE_STATS`
  ``tail_retained`` moved), the federator writes a rate-limited
  incident bundle (the implicated replica's flight-recorder doc, the
  merged Perfetto trace, the fleet statusz snapshot and the federated
  metrics page) into a timestamped ``incident_*`` directory: one bundle
  per ``incident_min_interval_s``.

Zero-overhead contract: every entry point is reached through
:func:`maybe_start_from_flags`, which reads ONE flag
(``FLAGS_fleet_monitor_port``) and returns None when it is 0 (the
default): no thread, no socket, no registry series.

The federator binds ``FLAGS_monitor_host`` (127.0.0.1 by default) and
fetches from the target URLs the operator configures.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import trace as trace_mod
from .metrics import MetricsRegistry, _label_key
from .server import AdminServer
from .slo import DEFAULT_ALERT_PAIRS, DEFAULT_WINDOWS, SLOTracker
from .timeseries import TimeseriesRing, parse_prometheus

__all__ = [
    "FleetTarget", "FederatorConfig", "FleetFederator",
    "merge_fleet_traces", "maybe_start_from_flags", "get_federator",
    "stop_federator", "SCRAPE_THREAD_PREFIX",
]

#: thread-name prefix of the federator's scrape loop — the fleet
#: zero-thread pin greps live thread names for this (the embedded admin
#: plane's threads carry server.THREAD_PREFIX already)
SCRAPE_THREAD_PREFIX = "ptpu-fleet"

#: availability vocabulary over serve_requests_total{event=...}:
#: cancelled/drained are client/operator choices and spend no budget
#: (matching the engine's own SLO feed, monitor/slo.py)
GOOD_EVENTS = ("completed",)
BAD_EVENTS = ("expired", "failed", "shed", "rejected")

_FETCH_TIMEOUT_S = 2.0


# ---------------------------------------------------------------------------
# Cross-process trace merging
# ---------------------------------------------------------------------------


def merge_fleet_traces(docs: Sequence[dict]) -> List[dict]:
    """Fold trace docs sharing a ``trace_id`` into single span trees.

    A doc that is alone under its trace_id and carries no
    ``parent_ctx`` passes through UNTOUCHED (integer span ids and all —
    single-process dumps render byte-identically). Groups merge under
    ctx-qualified string span ids; a doc root whose ``parent_ctx``
    token exists in the group parents there, otherwise it stays a root
    (its upstream process' buffer was lost — the subtree still
    renders). Merged docs carry ``merged_from`` (doc count) and
    ``processes`` (producing process labels, root-doc first); anomaly
    is the first non-None reason, ``head_sampled`` is any, ``finished``
    is all."""
    groups: Dict[Any, List[dict]] = {}
    for d in docs:
        groups.setdefault(d.get("trace_id"), []).append(d)
    out: List[dict] = []
    for trace_id, group in groups.items():
        if len(group) == 1 and not group[0].get("parent_ctx"):
            out.append(group[0])
            continue
        out.append(_merge_group(trace_id, group))
    return out


def _merge_group(trace_id: Any, group: List[dict]) -> dict:
    known = set()
    for d in group:
        ctx = d.get("ctx") or ""
        for s in d.get("spans") or ():
            known.add(f"{ctx}/{s.get('span_id')}")
    root_doc = None
    for d in group:
        pc = d.get("parent_ctx")
        if pc is None or pc not in known:
            root_doc = d
            break
    if root_doc is None:         # a parent cycle can only come from a
        root_doc = group[0]      # corrupt dump; degrade, don't crash
    spans: List[dict] = []
    processes: List[str] = []
    anomaly = None
    head_sampled = False
    finished = True
    for d in sorted(group, key=lambda d: 0 if d is root_doc else 1):
        ctx = d.get("ctx") or ""
        proc = d.get("process")
        if proc is not None and proc not in processes:
            processes.append(proc)
        if anomaly is None:
            anomaly = d.get("anomaly")
        head_sampled = head_sampled or bool(d.get("head_sampled"))
        finished = finished and bool(d.get("finished"))
        pc = d.get("parent_ctx")
        for s in d.get("spans") or ():
            ns = dict(s)
            ns["span_id"] = f"{ctx}/{s.get('span_id')}"
            pid = s.get("parent_id")
            if pid is None:
                # the doc's own root: parent it at the upstream token
                # when that span made it into the group
                ns["parent_id"] = pc if pc in known else None
            else:
                ns["parent_id"] = f"{ctx}/{pid}"
            if proc is not None:
                ns["process"] = proc
            spans.append(ns)
    return {"trace_id": trace_id, "name": root_doc.get("name"),
            "head_sampled": head_sampled, "anomaly": anomaly,
            "finished": finished, "spans": spans,
            "merged_from": len(group), "processes": processes}


# ---------------------------------------------------------------------------
# Scrape targets
# ---------------------------------------------------------------------------


@dataclass
class FleetTarget:
    """One federation target: a replica (or router) admin plane.

    ``url`` is the plane's base (``http://host:port``; ``/metrics``,
    ``/readyz`` and ``/debug/*`` derive from it). In-process fleets
    pass callables instead: ``fetch_metrics()`` returns an exposition
    page, ``fetch_ready()`` True/False, ``fetch_debug(path)`` a parsed
    JSON doc (or None)."""

    name: str
    url: Optional[str] = None
    fetch_metrics: Optional[Callable[[], str]] = None
    fetch_ready: Optional[Callable[[], bool]] = None
    fetch_debug: Optional[Callable[[str], Optional[dict]]] = None

    def metrics_text(self) -> str:
        if self.fetch_metrics is not None:
            return self.fetch_metrics()
        if self.url is None:
            raise ValueError(f"target {self.name!r}: no url and no "
                             "fetch_metrics callable")
        with urllib.request.urlopen(f"{self.url}/metrics",
                                    timeout=_FETCH_TIMEOUT_S) as r:
            return r.read().decode("utf-8", "replace")

    def ready(self) -> bool:
        if self.fetch_ready is not None:
            return bool(self.fetch_ready())
        if self.url is None:
            return True          # a callable-only target that answered
        try:                     # its scrape counts as ready
            with urllib.request.urlopen(f"{self.url}/readyz",
                                        timeout=_FETCH_TIMEOUT_S) as r:
                return r.status == 200
        except urllib.error.HTTPError as e:
            return e.code == 200
        except Exception:
            return False

    def debug_doc(self, path: str) -> Optional[dict]:
        """Fetch ``/debug/<path>`` as parsed JSON (None on any
        failure — incident capture is best-effort per artifact)."""
        try:
            if self.fetch_debug is not None:
                return self.fetch_debug(path)
            if self.url is None:
                return None
            with urllib.request.urlopen(f"{self.url}/debug/{path}",
                                        timeout=_FETCH_TIMEOUT_S) as r:
                return json.loads(r.read().decode("utf-8", "replace"))
        except Exception:
            return None


def parse_targets(spec: str) -> List[FleetTarget]:
    """``'name=http://host:port,...'`` → targets (the
    ``FLAGS_fleet_monitor_targets`` format). A bare URL gets its
    ``host:port`` as the name."""
    out: List[FleetTarget] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, url = part.split("=", 1)
        else:
            name, url = part.split("//")[-1].rstrip("/"), part
        out.append(FleetTarget(name=name.strip(),
                               url=url.strip().rstrip("/")))
    return out


def local_registry_target(name: str = "fleet") -> FleetTarget:
    """The in-process default (``FLAGS_fleet_monitor_targets`` empty):
    federate the process-global registry — the shape of an in-process
    fleet, where router and replicas already share one registry."""
    def _fetch() -> str:
        from .metrics import get_registry
        return get_registry().to_prometheus()

    def _debug(path: str) -> Optional[dict]:
        if path.startswith("flight"):
            from .flight_recorder import get_flight_recorder
            return get_flight_recorder().doc(reason="fleet_incident")
        return None

    return FleetTarget(name=name, fetch_metrics=_fetch,
                       fetch_debug=_debug)


# ---------------------------------------------------------------------------
# Federator
# ---------------------------------------------------------------------------


@dataclass
class FederatorConfig:
    #: scrape period (the loop's cadence; scrape_once() is also public
    #: for deterministic tests)
    interval_s: float = 1.0
    #: replicas that must be ready for fleet /readyz; None = majority
    quorum: Optional[int] = None
    #: fleet availability SLO objective fraction; 0.0 = no tracker
    slo_availability: float = 0.0
    slo_windows: Sequence[float] = DEFAULT_WINDOWS
    alert_pairs: Sequence[Tuple[float, float, float]] = \
        DEFAULT_ALERT_PAIRS
    #: where incident bundles land; None = incident capture off
    incident_dir: Optional[str] = None
    #: floor between bundles — an alert storm yields ONE bundle
    incident_min_interval_s: float = 300.0
    #: also capture when a tail-retained anomaly trace lands
    capture_on_anomaly: bool = True
    #: trailing window for /statusz fleet rates + quantiles
    window_s: float = 60.0


class FleetFederator:
    """The fleet scrape loop + its admin plane. ``router=`` optionally
    attaches a live :class:`~..serving.router.FleetRouter` so the
    ``/statusz`` replica table carries its authoritative per-replica
    view (free pages, alive/draining state) next to the scraped one."""

    def __init__(self, targets: Sequence[FleetTarget],
                 config: Optional[FederatorConfig] = None,
                 router=None, port: Optional[int] = None,
                 host: str = "127.0.0.1", clock=time.time):
        if not targets:
            raise ValueError("FleetFederator needs >= 1 target")
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate target names {names} — the "
                             "host label must identify ONE replica")
        self.targets = list(targets)
        self.config = config or FederatorConfig()
        self.router = router
        self.clock = clock
        #: the federated registry — REBUILT from the target pages every
        #: scrape (never written between scrapes)
        self.registry = MetricsRegistry()
        #: the federator's own telemetry, merged in after each rebuild
        self._own = MetricsRegistry()
        self.ring = TimeseriesRing(clock=clock)
        self.slo: Optional[SLOTracker] = None
        if self.config.slo_availability > 0.0:
            self.slo = SLOTracker(
                "fleet_availability", self.config.slo_availability,
                windows=self.config.slo_windows, clock=clock)
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._admin: Optional[AdminServer] = None
        self._admin_port = port
        self._admin_host = host
        #: last-seen serve_requests_total{host,event} values (the SLO
        #: delta baseline; resets fold to "count from new baseline")
        self._req_seen: Dict[Tuple[str, str], float] = {}
        #: per-scrape bad-event delta per host (implicates a replica)
        self._bad_delta: Dict[str, float] = {}
        self._target_state: Dict[str, str] = {
            t.name: "unscraped" for t in self.targets}
        self._last_incident_t: Optional[float] = None
        self._anomaly_seen = int(trace_mod.TRACE_STATS["tail_retained"])
        self.incidents: List[str] = []      # bundle dirs, oldest first

    # -- lifecycle ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def url(self) -> Optional[str]:
        return self._admin.url if self._admin is not None else None

    def start(self) -> "FleetFederator":
        if self._admin is None and self._admin_port is not None:
            admin = _FleetAdmin(self, port=self._admin_port,
                                host=self._admin_host, clock=self.clock)
            admin.register_readiness("fleet_quorum", self._quorum_check)
            admin.register_status("fleet", self._fleet_status)
            admin.start()
            self._admin = admin
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"{SCRAPE_THREAD_PREFIX}-scrape", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        a, self._admin = self._admin, None
        if a is not None:
            a.close()

    def _loop(self) -> None:
        while not self._stop.wait(max(0.01, self.config.interval_s)):
            try:
                self.scrape_once()
            except Exception:
                pass             # one bad scrape must not kill the loop

    # -- the scrape ---------------------------------------------------------
    def scrape_once(self, t: Optional[float] = None) -> dict:
        """One federation round: fetch + parse every target page,
        rebuild the fleet registry, feed the ring and SLO tracker,
        check alerts/anomalies, maybe capture an incident. Returns a
        summary dict (tests drive this directly with an injected
        clock)."""
        now = self.clock() if t is None else float(t)
        pages: List[Tuple[FleetTarget, MetricsRegistry]] = []
        for tgt in self.targets:
            try:
                rows = parse_prometheus(tgt.metrics_text())
            except Exception:
                self._own.counter(
                    "fleet_scrape_errors_total",
                    "federation scrapes that failed, by target"
                ).inc(host=tgt.name)
                self._target_state[tgt.name] = "unreachable"
                continue
            self._own.counter(
                "fleet_scrapes_total",
                "federation scrapes completed, by target").inc(
                host=tgt.name)
            self._target_state[tgt.name] = (
                "ready" if tgt.ready() else "not_ready")
            pages.append((tgt, _registry_from_rows(rows, tgt.name)))
        states = list(self._target_state.values())
        g = self._own.gauge("fleet_replicas",
                            "federation targets by last-scrape state")
        for state in ("ready", "not_ready", "unreachable", "unscraped"):
            g.set(states.count(state), state=state)
        with self._lock:
            # rebuild-from-scratch: each target page is already
            # cumulative, so the federated page must be the SUM of the
            # current pages, not an accumulation over scrape history
            self.registry.clear()
            for _, reg in pages:
                self.registry.merge(reg)
            self.registry.merge(self._own)
            self._feed_slo(now)
            if self.slo is not None:
                self.slo.publish(self.registry, t=now)
            self.ring.snapshot(self.registry, t=now)
        alerts = (self.slo.should_alert(self.config.alert_pairs, t=now)
                  if self.slo is not None else [])
        anomalies = 0
        tail = int(trace_mod.TRACE_STATS["tail_retained"])
        if tail > self._anomaly_seen:
            anomalies = tail - self._anomaly_seen
        self._anomaly_seen = tail
        bundle = None
        if alerts:
            bundle = self.capture_incident("slo_burn", t=now,
                                           alerts=alerts)
        elif anomalies and self.config.capture_on_anomaly:
            bundle = self.capture_incident("anomaly_trace", t=now,
                                           anomalies=anomalies)
        return {"t": now, "targets_scraped": len(pages),
                "alerts": alerts, "anomalies": anomalies,
                "incident": bundle}

    def _feed_slo(self, now: float) -> None:
        """Feed availability good/bad from the federated
        serve_requests_total{host,event} deltas. Caller holds _lock."""
        ctr = self.registry.get("serve_requests_total")
        if ctr is None:
            return
        good = bad = 0
        for labels, value in ctr.samples():
            event = labels.get("event")
            if event not in GOOD_EVENTS and event not in BAD_EVENTS:
                continue
            key = (labels.get("host", ""), str(event))
            last = self._req_seen.get(key, 0.0)
            # reset folding: a restarted replica counts from its own
            # new baseline (the gap contributes nothing)
            delta = value - last if value >= last else value
            self._req_seen[key] = value
            if delta <= 0:
                continue
            if event in GOOD_EVENTS:
                good += int(delta)
            else:
                bad += int(delta)
                self._bad_delta[key[0]] = \
                    self._bad_delta.get(key[0], 0.0) + delta
        if self.slo is not None and (good or bad):
            self.slo.record(good=good, bad=bad, t=now)

    # -- fleet views --------------------------------------------------------
    def merged_traces(self) -> List[dict]:
        """Every trace doc the fleet can see — the local tracer's
        buffer plus each URL target's ``/debug/trace`` — merged by
        trace_id into single span trees."""
        docs = list(trace_mod.get_tracer().snapshot(include_live=True))
        for tgt in self.targets:
            if tgt.url is None and tgt.fetch_debug is None:
                continue
            d = tgt.debug_doc("trace")
            for td in (d or {}).get("traces") or ():
                docs.append(td)
        seen = set()
        unique = []
        for d in docs:           # a target sharing this process' tracer
            key = (d.get("trace_id"), d.get("ctx"))   # yields dupes
            if d.get("ctx") is not None and key in seen:
                continue
            seen.add(key)
            unique.append(d)
        return merge_fleet_traces(unique)

    def _quorum_check(self) -> Optional[dict]:
        ready = sum(1 for s in self._target_state.values()
                    if s == "ready")
        need = (self.config.quorum if self.config.quorum is not None
                else len(self.targets) // 2 + 1)
        if ready >= need:
            return None
        return {"state": "no-quorum", "ready": ready, "need": need,
                "targets": dict(self._target_state)}

    def _fleet_status(self) -> dict:
        """The /statusz 'fleet' section: one row per replica (scraped
        state + queue/pages/prefix-hit off the federated registry,
        free pages and aliveness from an attached router), a per-tenant
        rollup, windowed fleet rates and e2e quantiles."""
        w = self.config.window_s
        per: Dict[str, dict] = {}
        for tgt in self.targets:
            h = tgt.name
            row: Dict[str, Any] = {
                "state": self._target_state.get(h, "unscraped"),
                "queue_depth": self._gauge_val("serve_queue_depth", h),
                "kv_pages_in_use": self._gauge_val(
                    "serve_kv_pages_in_use", h),
                "overloaded": bool(self._gauge_val("serve_overload", h)
                                   or 0.0),
                "prefix_hit_pct": self._prefix_hit_pct(h),
            }
            per[h] = row
        if self.router is not None:
            try:
                for name, rep in self.router.replicas.items():
                    row = per.setdefault(name, {"state": "router-only"})
                    row["alive"] = rep.alive
                    if rep.alive:
                        s = rep.status()
                        row["free_pages"] = s.get("free_pages")
                        row.setdefault("queue_depth",
                                       s.get("queue_depth"))
            except Exception:
                pass
        doc: Dict[str, Any] = {
            "targets": per,
            "tenants": self._tenant_rollup(),
            "rates": {"window_s": w,
                      "per_second": self.ring.rates(window_s=w)},
        }
        for h in per:
            for q in (0.5, 0.99):
                v = self.ring.quantile("serve_e2e_seconds", q,
                                       window_s=w, host=h)
                if v is not None:
                    per[h][f"e2e_p{int(q * 100)}_s"] = v
        if self.slo is not None:
            doc["slo"] = self.slo.snapshot()
        if self.incidents:
            doc["incidents"] = list(self.incidents[-5:])
        return doc

    def _gauge_val(self, name: str, host: str) -> Optional[float]:
        with self._lock:
            m = self.registry.get(name)
            if m is None:
                return None
            for labels, value in m.samples():
                if labels.get("host") == host:
                    return float(value)
        return None

    def _counter_sum(self, name: str, host: str) -> float:
        total = 0.0
        with self._lock:
            m = self.registry.get(name)
            if m is None:
                return 0.0
            for labels, value in m.samples():
                if labels.get("host") == host:
                    total += float(value)
        return total

    def _prefix_hit_pct(self, host: str) -> Optional[float]:
        hits = self._counter_sum("serve_prefix_hits_total", host)
        misses = self._counter_sum("serve_prefix_misses_total", host)
        if hits + misses <= 0:
            return None
        return 100.0 * hits / (hits + misses)

    def _tenant_rollup(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        with self._lock:
            m = self.registry.get("serve_tenant_requests_total")
            if m is None:
                return out
            for labels, value in m.samples():
                tenant = labels.get("tenant", "?")
                row = out.setdefault(tenant, {})
                ev = labels.get("event", "?")
                row[ev] = row.get(ev, 0.0) + float(value)
        return out

    # -- incident capture ---------------------------------------------------
    def capture_incident(self, trigger: str,
                         t: Optional[float] = None,
                         **detail) -> Optional[str]:
        """Write one incident bundle (rate-limited). Returns the bundle
        dir, or None when capture is off / inside the rate floor."""
        if not self.config.incident_dir:
            return None
        now = self.clock() if t is None else float(t)
        with self._lock:
            if (self._last_incident_t is not None
                    and now - self._last_incident_t
                    < self.config.incident_min_interval_s):
                return None
            self._last_incident_t = now
        d = os.path.join(self.config.incident_dir,
                         f"incident_{int(now * 1000)}_{trigger}")
        os.makedirs(d, exist_ok=True)
        implicated = self._implicated_target()
        self._write_json(os.path.join(d, "incident.json"), {
            "trigger": trigger, "t": now,
            "implicated": implicated.name if implicated else None,
            "targets": dict(self._target_state),
            "slo": self.slo.snapshot() if self.slo else None,
            **detail})
        self._write_json(os.path.join(d, "statusz.json"),
                         self._fleet_status())
        with self._lock:
            page = self.registry.to_prometheus()
        with open(os.path.join(d, "metrics.prom"), "w") as f:
            f.write(page)
        flight = (implicated.debug_doc("flight")
                  if implicated is not None else None)
        if flight is None:       # fall back to the local recorder
            try:
                from .flight_recorder import get_flight_recorder
                flight = get_flight_recorder().doc(
                    reason=f"fleet_incident:{trigger}")
            except Exception:
                flight = None
        if flight is not None:
            self._write_json(os.path.join(d, "flight.json"), flight)
        try:
            self._write_json(
                os.path.join(d, "trace_perfetto.json"),
                trace_mod.perfetto_doc(self.merged_traces(),
                                       include_host_timeline=False))
        except Exception:
            pass
        self._own.counter(
            "fleet_incidents_total",
            "incident bundles captured, by trigger").inc(
            trigger=trigger)
        self.incidents.append(d)
        return d

    def _implicated_target(self) -> Optional[FleetTarget]:
        """The replica to pull forensics from: worst bad-event delta
        since the last incident, else the first unreachable/not-ready
        one, else the first target."""
        if self._bad_delta:
            worst = max(self._bad_delta, key=self._bad_delta.get)
            self._bad_delta.clear()
            for tgt in self.targets:
                if tgt.name == worst:
                    return tgt
        for state in ("unreachable", "not_ready"):
            for tgt in self.targets:
                if self._target_state.get(tgt.name) == state:
                    return tgt
        return self.targets[0] if self.targets else None

    @staticmethod
    def _write_json(path: str, doc: Any) -> None:
        from .flight_recorder import _json_safe_tree
        with open(path, "w") as f:
            json.dump(_json_safe_tree(doc), f, indent=1)


def _registry_from_rows(rows: List[dict],
                        host: str) -> MetricsRegistry:
    """A one-page registry with ``host=<name>`` stamped on EVERY
    sample — counters with distinct hosts stay distinct series, so
    merging the per-target registries sums nothing away."""
    reg = MetricsRegistry()
    for r in rows:
        kind = r.get("type")
        if kind not in ("counter", "gauge"):
            kind = "gauge"       # histograms arrive pre-flattened as
        try:                     # typed _bucket/_count/_sum counters
            m = reg._raw_metric(str(r["name"]), kind)
        except (TypeError, KeyError):
            continue
        labels = dict(r.get("labels") or {})
        labels["host"] = host
        m._series[_label_key(labels)] = float(r["value"])
    return reg


class _FleetAdmin(AdminServer):
    """The federator's admin plane: same endpoints as a replica's, but
    ``/metrics``//``/statusz`` read the FEDERATED registry/ring and
    ``/debug/trace`` serves the MERGED fleet trace view."""

    def __init__(self, fed: FleetFederator, **kw):
        super().__init__(registry=fed.registry, ring=fed.ring, **kw)
        self._fed = fed

    def _debug_trace(self, h, query) -> None:
        docs = self._fed.merged_traces()
        if query.get("format") == "perfetto":
            return self._json(h, trace_mod.perfetto_doc(docs))
        self._json(h, {"format": 1, "dumped_at": self.clock(),
                       "traces": docs})


# ---------------------------------------------------------------------------
# Flag-gated process-global federator
# ---------------------------------------------------------------------------

_federator: Optional[FleetFederator] = None
_federator_lock = threading.Lock()


def maybe_start_from_flags() -> Optional[FleetFederator]:
    """Start (or return) the process-global federator when
    ``FLAGS_fleet_monitor_port`` is set; None — after ONE flag read,
    zero allocations — when it is 0 (the default). ``-1`` binds an
    ephemeral port (read it back from ``get_federator().url``)."""
    from ..core.flags import get_flag
    port = int(get_flag("fleet_monitor_port") or 0)
    if port == 0:
        return None
    global _federator
    with _federator_lock:
        if _federator is None or not _federator.running:
            targets = parse_targets(
                str(get_flag("fleet_monitor_targets") or ""))
            if not targets:
                targets = [local_registry_target()]
            cfg = FederatorConfig(
                interval_s=float(
                    get_flag("fleet_monitor_interval_s") or 1.0),
                slo_availability=float(
                    get_flag("fleet_monitor_slo") or 0.0),
                incident_dir=(
                    str(get_flag("fleet_monitor_incident_dir") or "")
                    or None))
            host = str(get_flag("monitor_host") or "127.0.0.1")
            fed = FleetFederator(targets, cfg,
                                 port=(0 if port < 0 else port),
                                 host=host)
            try:
                fed.start()
            except OSError as e:
                import warnings
                warnings.warn(
                    f"fleet federator failed to bind {host}:{port} "
                    f"({e}); fleet plane disabled for this process",
                    RuntimeWarning)
                return None
            _federator = fed
        return _federator


def get_federator() -> Optional[FleetFederator]:
    """The process-global federator, if one is running."""
    return _federator


def stop_federator() -> None:
    """Tear down the process-global federator (tests / shutdown)."""
    global _federator
    with _federator_lock:
        if _federator is not None:
            _federator.close()
            _federator = None
