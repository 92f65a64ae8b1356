"""Structured tracing: request/step span trees with tail-based anomaly
sampling (docs/OBSERVABILITY.md "Structured tracing"). A copy of
``paddle_tpu/monitor/trace.py``; its Perfetto export merges the port's
profiler host timeline.

The counters and histograms of :mod:`.metrics` say *how much*; this
module says *where a specific request's (or step's) time went*. The
model is Dapper's — every unit of work is a **trace** (one serving
request, one training step) made of **spans** (trace_id, span_id,
parent link, name, start/end, free-form attributes) — with two
retention rules composed:

- **head sampling**: at trace start a coin flips at
  ``FLAGS_trace_sample`` (default 0.01) — the cheap rate that keeps a
  production engine's trace volume bounded;
- **tail-based anomaly keep**: every trace is *buffered* while open,
  and one that turns out to contain an anomaly — an
  expired/shed/failed/watchdog/chaos/nonfinite event
  (:data:`ANOMALY_REASONS`) — is retained REGARDLESS of the head
  decision. The weird ones are the ones you read; keeping 1% of healthy
  traffic and 100% of incidents is the whole point.

Retained traces live in a bounded ring (``FLAGS_trace_ring``, the
flight-recorder model) and ship three ways:

- :func:`export_perfetto` — one merged Perfetto/chrome-trace JSON:
  trace span trees on per-trace tracks next to the profiler's host
  ``RecordEvent`` timeline (comm events included), openable in
  ``ui.perfetto.dev`` / ``chrome://tracing``;
- the tracer registers a **flight-recorder dump provider**, so a crash
  dump carries the retained *and still-open* traces of the moment it
  died (``monitor_report.py --flight`` readers see them under
  ``"traces"``);
- :meth:`Tracer.dump` writes a standalone JSON rendered by
  ``tools/monitor_report.py --trace`` (span trees with critical-path
  and exclusive-time attribution).

Zero-overhead contract: with ``FLAGS_trace`` off (default),
:func:`start_trace` returns None before allocating anything — the
span-allocation probe :data:`TRACE_STATS` reads 0 and no registry
series are written, pinned by tests/test_torch_monitor.py.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span", "Trace", "Tracer", "get_tracer", "set_tracer", "enabled",
    "start_trace", "current_trace", "activate", "maybe_span",
    "export_perfetto", "perfetto_doc", "ANOMALY_REASONS", "TRACE_STATS",
    "reset_trace_stats", "load_trace_dump",
]

#: anomaly reasons that force tail-retention of a trace (the serving /
#: training failure modes a post-mortem starts from)
ANOMALY_REASONS = ("expired", "shed", "failed", "watchdog", "chaos",
                   "nonfinite", "health_spike")

#: allocation probe: the zero-overhead pin reads spans_allocated == 0
#: with FLAGS_trace off (tests/test_torch_monitor.py)
TRACE_STATS = {"spans_allocated": 0, "traces_started": 0,
               "traces_retained": 0, "traces_dropped": 0,
               "tail_retained": 0}


def reset_trace_stats() -> None:
    for k in TRACE_STATS:
        TRACE_STATS[k] = 0


_trace_seq = itertools.count(1)


def _new_trace_id() -> str:
    return f"{os.getpid():x}-{next(_trace_seq):04x}"


_ctx_seq = itertools.count(1)


def _new_ctx() -> str:
    """Per-Trace context handle, unique ACROSS processes (pid-scoped) —
    the namespace cross-process span references live in. Two processes
    (or two engines in one process) can buffer the same ``trace_id``
    concurrently; their ctx handles never collide, so the fleet merge
    (monitor/fleet.py) can join their spans without id clashes."""
    return f"{os.getpid():x}.{next(_ctx_seq):x}"


class Span:
    """One timed unit of work inside a trace. ``t1`` is None while
    open; ``attrs`` are free-form JSON-safe values."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs")

    def __init__(self, trace_id: str, span_id: int,
                 parent_id: Optional[int], name: str, t0: float,
                 attrs: Dict[str, Any]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        TRACE_STATS["spans_allocated"] += 1

    @property
    def duration(self) -> Optional[float]:
        return None if self.t1 is None else max(0.0, self.t1 - self.t0)

    def set_attrs(self, **attrs) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t0": self.t0, "t1": self.t1,
                "attrs": {k: _json_safe(v)
                          for k, v in self.attrs.items()}}


def _json_safe(v: Any) -> Any:
    """Non-finite floats serialize as strings ('nan' may be the whole
    point of an anomaly attr) so trace dicts stay valid under
    ``json.dumps(allow_nan=False)`` — the flight-recorder dump's mode."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    try:
        f = float(v)
    except Exception:
        return repr(v)
    return f if math.isfinite(f) else repr(f)


class Trace:
    """One span tree. The root span shares the trace's name and covers
    its whole lifetime; :meth:`span`/:meth:`start_span` children default
    to the root as parent (explicit ``parent=`` nests deeper). Spans may
    open and close at *different* call sites across iterations (the
    serving lifecycle) — handles, not a stack."""

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 head_sampled: bool, t0: float,
                 attrs: Dict[str, Any],
                 process: Optional[str] = None,
                 parent: Optional[str] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.head_sampled = head_sampled
        #: unique buffer handle (see :func:`_new_ctx`) — the namespace
        #: qualifying this trace's span ids in cross-process references
        self.ctx = _new_ctx()
        #: which process/replica produced this span tree (one Perfetto
        #: track per distinct process in the merged fleet doc)
        self.process = process
        #: ``"<ctx>/<span_id>"`` of the span (in ANOTHER trace buffer,
        #: usually another process) this tree's root parents under —
        #: the Dapper join the fleet merge resolves
        self.parent_ctx = parent
        #: first anomaly reason seen (None = healthy so far)
        self.anomaly: Optional[str] = None
        self.finished = False
        self._span_seq = itertools.count(1)
        self.root = Span(trace_id, 0, None, name, t0, dict(attrs))
        self.spans: List[Span] = [self.root]

    # -- span surface -------------------------------------------------------
    def start_span(self, name: str, parent: Optional[Span] = None,
                   t: Optional[float] = None, **attrs) -> Span:
        sp = Span(self.trace_id, next(self._span_seq),
                  (parent if parent is not None else self.root).span_id,
                  name, self._tracer.clock() if t is None else t, attrs)
        with self._tracer._lock:
            self.spans.append(sp)
        return sp

    def end_span(self, span: Span, t: Optional[float] = None,
                 **attrs) -> Span:
        if attrs:
            span.attrs.update(attrs)
        if span.t1 is None:
            span.t1 = self._tracer.clock() if t is None else t
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> Iterator[Span]:
        sp = self.start_span(name, parent=parent, **attrs)
        try:
            yield sp
        finally:
            self.end_span(sp)

    def event(self, name: str, t: Optional[float] = None,
              **attrs) -> Span:
        """Zero-duration marker span (terminal transitions, preemption
        boundaries)."""
        sp = self.start_span(name, t=t, **attrs)
        sp.t1 = sp.t0
        return sp

    def context_for(self, span: Optional[Span] = None) -> str:
        """The propagation token for ``span`` (default: the root):
        ``"<ctx>/<span_id>"``, globally unambiguous. A downstream
        process opens its trace with ``parent=<token>`` (same
        ``trace_id``) and the fleet merge parents its root there."""
        sp = span if span is not None else self.root
        return f"{self.ctx}/{sp.span_id}"

    def mark_anomaly(self, reason: str, **attrs) -> None:
        """Flag the trace for tail-retention. The FIRST reason sticks
        (it is the one that made the trace weird); later marks only add
        attributes."""
        if self.anomaly is None:
            self.anomaly = str(reason)
        if attrs:
            self.root.attrs.update(attrs)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        with self._tracer._lock:
            spans = [s.to_dict() for s in self.spans]
        d = {"trace_id": self.trace_id, "name": self.name,
             "ctx": self.ctx,
             "head_sampled": self.head_sampled,
             "anomaly": self.anomaly, "finished": self.finished,
             "spans": spans}
        if self.process is not None:
            d["process"] = self.process
        if self.parent_ctx is not None:
            d["parent_ctx"] = self.parent_ctx
        return d


class Tracer:
    """Process-global trace buffer: open traces + a bounded ring of
    retained (finished) ones."""

    def __init__(self, capacity: Optional[int] = None,
                 clock=time.perf_counter, seed: Optional[int] = None):
        if capacity is None:
            try:
                from ..core.flags import get_flag
                capacity = int(get_flag("trace_ring"))
            except Exception:
                capacity = 64
        self.capacity = max(1, int(capacity))
        self.clock = clock
        self._lock = threading.RLock()
        self._live: Dict[str, Trace] = {}
        self._retained: List[Trace] = []
        self._rng = random.Random(seed)

    def _sample_rate(self) -> float:
        try:
            from ..core.flags import get_flag
            return float(get_flag("trace_sample"))
        except Exception:
            return 0.0

    # -- lifecycle ----------------------------------------------------------
    def start_trace(self, name: str, trace_id: Optional[str] = None,
                    sample: Optional[bool] = None, t: Optional[float]
                    = None, process: Optional[str] = None,
                    parent: Optional[str] = None, **attrs) -> Trace:
        """Open a trace. ``trace_id`` resumes an identity (drain/resume
        and the fleet router hand the id across engines); ``sample``
        overrides the head coin (tests, resumed traces that were
        already being kept); ``process`` labels the producing
        process/replica (one Perfetto track per process in the merged
        fleet doc); ``parent`` is a :meth:`Trace.context_for` token the
        new tree's root parents under — the cross-process Dapper link.
        The live table keys on the per-Trace ``ctx`` handle, so a
        router trace and an in-process replica trace may buffer the
        SAME trace_id concurrently without evicting each other."""
        if sample is None:
            rate = self._sample_rate()
            sample = (rate >= 1.0
                      or (rate > 0.0 and self._rng.random() < rate))
        tr = Trace(self, name,
                   trace_id if trace_id else _new_trace_id(),
                   bool(sample), self.clock() if t is None else t,
                   attrs, process=process, parent=parent)
        with self._lock:
            self._live[tr.ctx] = tr
            TRACE_STATS["traces_started"] += 1
        return tr

    def finish_trace(self, trace: Trace, t: Optional[float] = None) \
            -> bool:
        """Close the root span and apply the retention decision:
        head-sampled OR anomalous ⇒ ring; else dropped. Returns whether
        the trace was retained. Idempotent."""
        with self._lock:
            if trace.finished:
                return trace in self._retained
            trace.finished = True
            self._live.pop(trace.ctx, None)
            trace.end_span(trace.root, t=t)
            keep = trace.head_sampled or trace.anomaly is not None
            if keep:
                if trace.anomaly is not None and not trace.head_sampled:
                    TRACE_STATS["tail_retained"] += 1
                TRACE_STATS["traces_retained"] += 1
                self._retained.append(trace)
                if len(self._retained) > self.capacity:
                    del self._retained[:len(self._retained)
                                       - self.capacity]
            else:
                TRACE_STATS["traces_dropped"] += 1
            return keep

    # -- reads --------------------------------------------------------------
    def retained(self) -> List[Trace]:
        with self._lock:
            return list(self._retained)

    def live(self) -> List[Trace]:
        with self._lock:
            return list(self._live.values())

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._retained.clear()

    # -- export -------------------------------------------------------------
    def snapshot(self, include_live: bool = True) -> List[dict]:
        return [t.to_dict() for t in self.retained()] + \
            ([t.to_dict() for t in self.live()] if include_live else [])

    def dump(self, path: str, include_live: bool = True) -> str:
        """Standalone trace dump (atomic rename), rendered by
        ``tools/monitor_report.py --trace <path>``."""
        doc = {"format": 1, "dumped_at": time.time(),
               "traces": self.snapshot(include_live=include_live)}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path


def load_trace_dump(path: str) -> List[dict]:
    """Parse a :meth:`Tracer.dump` file (or a flight-recorder dump that
    carries a ``traces`` section) into a list of trace dicts."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return doc
    return list(doc.get("traces") or [])


# ---------------------------------------------------------------------------
# Process-global tracer + flag gate
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (created on first use; registers the
    flight-recorder dump provider so crash dumps carry traces)."""
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer()
            _register_flight_provider()
        return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Swap the process-global tracer (tests); returns the old one."""
    global _tracer
    with _tracer_lock:
        old, _tracer = _tracer, tracer
        return old


def _register_flight_provider() -> None:
    try:
        from . import flight_recorder as _flight
        _flight.register_dump_provider("traces", _flight_traces)
    except Exception:
        pass


def _flight_traces() -> List[dict]:
    """Flight-recorder dump provider: retained + in-flight traces, so a
    crash ships the span trees of whatever it was serving."""
    t = _tracer
    return t.snapshot(include_live=True) if t is not None else []


def enabled() -> bool:
    """True when ``FLAGS_trace`` is on — the ONE gate every hot path
    reads before touching the tracer."""
    from ..core.flags import get_flag
    return bool(get_flag("trace"))


def start_trace(name: str, **kw) -> Optional[Trace]:
    """Flag-gated entry point: None (no allocation at all) when
    ``FLAGS_trace`` is off."""
    if not enabled():
        return None
    return get_tracer().start_trace(name, **kw)


# -- current-trace context (training step spans attach through this) --------

_current = threading.local()


def current_trace() -> Optional[Trace]:
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activate(trace: Optional[Trace]) -> Iterator[Optional[Trace]]:
    """Make ``trace`` the thread's current trace for the with-block so
    nested instrumentation (eager collectives, checkpoint commits) can
    attach child spans via :func:`maybe_span`. None = no-op."""
    if trace is None:
        yield None
        return
    stack = getattr(_current, "stack", None)
    if stack is None:
        stack = _current.stack = []
    stack.append(trace)
    try:
        yield trace
    finally:
        stack.pop()


@contextlib.contextmanager
def maybe_span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """Open ``name`` under the thread's current trace, or do nothing
    when there is none (the cheap seam for instrumentation that cannot
    know whether a trace is active — collective dispatches, checkpoint
    commits). Never raises out of the guard."""
    tr = current_trace()
    if tr is None:
        yield None
        return
    sp = tr.start_span(name, **attrs)
    try:
        yield sp
    finally:
        tr.end_span(sp)


# ---------------------------------------------------------------------------
# Perfetto / chrome-trace export
# ---------------------------------------------------------------------------


def perfetto_doc(traces: Optional[List[dict]] = None,
                 include_host_timeline: bool = True) -> dict:
    """The merged Perfetto/chrome-trace document as a dict — what
    :func:`export_perfetto` writes. Factored out so the admin server's
    ``/debug/trace?format=perfetto`` serves it straight from memory.

    Track model: one Perfetto *process* (pid) per distinct
    producing process label — a trace doc's ``process`` field, or a
    per-span ``process`` key in a fleet-merged doc — and inside each
    process ONE track (tid) per ``trace_id``. Docs without a process
    label all land on the classic ``paddle_tpu.trace`` pid, and
    distinct trace_ids get distinct tids, so single-process exports
    render exactly as before; a merged fleet trace renders as the
    router process plus one process per replica, each showing its own
    slice of the same request side by side."""
    if traces is None:
        traces = get_tracer().snapshot(include_live=True)
    events: List[dict] = []
    meta: List[dict] = []
    pids: Dict[Optional[str], int] = {}
    tids: Dict[tuple, int] = {}

    def _pid(proc: Optional[str]) -> int:
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            label = ("paddle_tpu.trace" if proc is None
                     else f"paddle_tpu.trace:{proc}")
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "args": {"name": label}})
        return pid

    def _tid(pid: int, tdoc: dict) -> int:
        key = (pid, tdoc.get("trace_id"))
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = 1 + sum(1 for p, _ in tids if p == pid)
            label = (f"{tdoc.get('name', 'trace')} "
                     f"{tdoc.get('trace_id', '')}")
            if tdoc.get("anomaly"):
                label += f" [ANOMALY:{tdoc['anomaly']}]"
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": label}})
        return tid

    for tdoc in traces:
        doc_proc = tdoc.get("process")
        for s in tdoc.get("spans") or []:
            t0 = s.get("t0")
            if t0 is None:
                continue
            pid = _pid(s.get("process", doc_proc))
            tid = _tid(pid, tdoc)
            t1 = s.get("t1")
            dur = 0.0 if t1 is None else max(0.0, float(t1) - float(t0))
            args = dict(s.get("attrs") or {})
            args["trace_id"] = tdoc.get("trace_id")
            args["span_id"] = s.get("span_id")
            if s.get("parent_id") is not None:
                args["parent_id"] = s.get("parent_id")
            events.append({"name": s.get("name", "?"), "ph": "X",
                           "ts": float(t0) * 1e6, "dur": dur * 1e6,
                           "pid": pid, "tid": tid, "cat": "trace",
                           "args": args})
    if include_host_timeline:
        try:
            from ..profiler import _timeline
            meta.append({"ph": "M", "name": "process_name", "pid": 0,
                         "args": {"name": "host (profiler)"}})
            for name, ts, dur, tid in list(_timeline):
                events.append({"name": name, "ph": "X", "ts": ts,
                               "dur": dur, "pid": 0,
                               "tid": tid % 100000, "cat": "host"})
        except Exception:
            pass
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_perfetto(path: str, traces: Optional[List[dict]] = None,
                    include_host_timeline: bool = True) -> str:
    """Write ONE merged Perfetto/chrome-trace JSON: every retained (and
    open) trace's span tree on its own track, plus the profiler's host
    ``RecordEvent`` timeline (step spans, ``comm::<op>`` events, eager
    op dispatches) on per-thread tracks — the unified timeline the
    reference's device_tracer assembled from CUPTI + host events.

    Timestamps are microseconds in the host ``perf_counter`` domain
    (both sources share it), emitted sorted per track so the file loads
    with monotonic track clocks. Openable in ui.perfetto.dev or
    chrome://tracing."""
    doc = perfetto_doc(traces, include_host_timeline)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
