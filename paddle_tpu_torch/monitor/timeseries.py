"""In-memory timeseries ring: registry snapshots over time, so the live
telemetry plane can show *movement*, not just cumulative counters
(docs/OBSERVABILITY.md "Live telemetry plane"). A copy of
``paddle_tpu/monitor/timeseries.py``, which imports no JAX.

The metrics registry holds the CURRENT value of every series; an
operator watching a live process wants tokens/s, requests/s, burn — the
derivative. :class:`TimeseriesRing` keeps a bounded ring of
``(t, value)`` points per series, appended by :meth:`snapshot` (called
per ``/metrics``/``/statusz`` scrape by the admin server, or per
redraw by ``tools/monitor_top.py``), and answers:

- :meth:`rate` — Δvalue/Δt over a trailing window (counter semantics:
  a negative delta means the writer restarted, so the window restarts
  at the newest segment instead of reporting a negative rate);
- :meth:`delta` — plain Δvalue over the window;
- :meth:`latest` / :meth:`series` — current value / the raw points.

Histograms flatten into their Prometheus sample names: ``<name>_count``
and ``<name>_sum`` plus one cumulative ``<name>_bucket`` series per
``le`` bound, so ``rate("serve_e2e_seconds_count")`` is
completions/s, ``delta(sum)/delta(count)`` is the windowed mean
latency, and :meth:`quantile` interpolates a WINDOWED p50/p99 off the
bucket deltas (counter-reset folding applies to bucket series exactly
as to any counter — a restarted replica's scrape cannot yield negative
bucket mass).

Everything is host-side floats under one lock; a ring of 256 snapshots
of a few hundred series is ~100 KiB. Nothing here touches the registry
unless :meth:`snapshot` is called — the zero-overhead contract of the
monitor-off path is untouched.

:func:`parse_prometheus` is the inverse of
``MetricsRegistry.to_prometheus`` for the subset the ring needs
(counter/gauge samples + histogram ``_count``/``_sum``/``_bucket``
lines) — it lets ``tools/monitor_top.py`` and the fleet federator feed
a ring from a scraped ``/metrics`` page of ANY process, not just this
one.
"""

from __future__ import annotations

import collections
import math
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

# grammar atoms shared with the conformance lint (metrics.py) — the
# lenient parser and the strict lint must never drift apart
from .metrics import _L_LABEL_NAME, _L_METRIC_NAME, _L_NUM

__all__ = ["TimeseriesRing", "parse_prometheus"]

_SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class TimeseriesRing:
    """Bounded per-series history of registry (or scraped) samples."""

    def __init__(self, capacity: int = 256, clock=time.time):
        self.capacity = max(2, int(capacity))
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[_SeriesKey, collections.deque] = {}
        self._kinds: Dict[str, str] = {}
        self.snapshots_taken = 0

    # -- ingestion ----------------------------------------------------------
    def snapshot(self, registry=None, t: Optional[float] = None) -> int:
        """Append one point per series from ``registry`` (default: the
        active :func:`~paddle_tpu_torch.monitor.metrics.get_registry`).
        Returns the number of series touched."""
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        now = self.clock() if t is None else float(t)
        rows = []
        for name, info in registry.snapshot().items():
            kind = info["type"]
            for labels, value in info["samples"]:
                if kind == "histogram":
                    rows.append((f"{name}_count", labels, "counter",
                                 float(value["count"])))
                    rows.append((f"{name}_sum", labels, "counter",
                                 float(value["sum"])))
                    # per-bucket cumulative series on the exposition's
                    # exact `le` grid — the windowed bucket deltas
                    # `quantile` interpolates over
                    for le, cum in value["buckets"]:
                        rows.append((f"{name}_bucket",
                                     dict(labels, le=repr(float(le))),
                                     "counter", float(cum)))
                    rows.append((f"{name}_bucket",
                                 dict(labels, le="+Inf"),
                                 "counter", float(value["count"])))
                else:
                    rows.append((name, labels, kind, float(value)))
        return self._ingest(rows, now)

    def ingest_rows(self, rows: List[dict],
                    t: Optional[float] = None) -> int:
        """Append points from :func:`parse_prometheus` output (dicts
        with ``name``/``labels``/``type``/``value``)."""
        now = self.clock() if t is None else float(t)
        return self._ingest(
            [(r["name"], r.get("labels") or {}, r.get("type", "gauge"),
              float(r["value"])) for r in rows
             if isinstance(r.get("value"), (int, float))], now)

    def _ingest(self, rows, now: float) -> int:
        with self._lock:
            for name, labels, kind, value in rows:
                key = (name, tuple(sorted(
                    (k, str(v)) for k, v in dict(labels).items())))
                dq = self._series.get(key)
                if dq is None:
                    dq = self._series[key] = collections.deque(
                        maxlen=self.capacity)
                dq.append((now, value))
                self._kinds[name] = kind
            self.snapshots_taken += 1
            return len(rows)

    # -- reads --------------------------------------------------------------
    def _key(self, name: str, labels: dict) -> _SeriesKey:
        return (name, tuple(sorted((k, str(v))
                                   for k, v in labels.items())))

    def names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def series(self, name: str, **labels) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._series.get(self._key(name, labels), ()))

    def label_sets(self, name: str) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k[1]) for k in self._series if k[0] == name]

    def latest(self, name: str, **labels) -> Optional[float]:
        pts = self.series(name, **labels)
        return pts[-1][1] if pts else None

    def _window(self, name: str, window_s: Optional[float],
                labels: dict) -> List[Tuple[float, float]]:
        pts = self.series(name, **labels)
        if window_s is None or not pts:
            return pts
        lo = pts[-1][0] - float(window_s)
        return [p for p in pts if p[0] >= lo]

    def delta(self, name: str, window_s: Optional[float] = None,
              **labels) -> Optional[float]:
        """newest − oldest value inside the trailing window (None with
        < 2 points). Counter resets (negative segments) are folded out
        the same way :meth:`rate` folds them."""
        pts = self._window(name, window_s, labels)
        if len(pts) < 2:
            return None
        total = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b >= a:
                total += b - a
            # else: writer restarted; the post-reset segment counts
            # from its own baseline (b - 0 would over-credit partial
            # scrapes, so the reset gap itself contributes nothing)
        return total

    def rate(self, name: str, window_s: Optional[float] = None,
             **labels) -> Optional[float]:
        """Per-second rate over the trailing window: Δvalue/Δt with
        counter-reset folding. None with < 2 points or zero time span."""
        pts = self._window(name, window_s, labels)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        d = self.delta(name, window_s, **labels)
        return None if d is None else d / span

    def quantile(self, name: str, q: float,
                 window_s: Optional[float] = None,
                 **labels) -> Optional[float]:
        """WINDOWED quantile interpolated from ``<name>_bucket`` deltas
        (Prometheus ``histogram_quantile`` semantics: linear inside the
        winning bucket, the last finite bound when q lands in +Inf).
        Counter resets fold out per bucket series, so a restarted
        writer shrinks the window's mass instead of corrupting it.
        None when no bucket series match or the window saw no
        observations — a quantile over nothing is not 0.0."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        bname = f"{name}_bucket"
        want = {k: str(v) for k, v in labels.items()}
        grid: List[Tuple[float, float]] = []
        for ls in self.label_sets(bname):
            le = ls.get("le")
            if le is None:
                continue
            if {k: v for k, v in ls.items() if k != "le"} != want:
                continue
            d = self.delta(bname, window_s, **ls)
            if d is None:
                continue
            grid.append((math.inf if le == "+Inf" else float(le), d))
        if not grid:
            return None
        grid.sort()
        total = grid[-1][1]
        if total <= 0:
            return None
        target = q * total
        prev_b, prev_c = 0.0, 0.0
        for bound, cum in grid:
            if cum >= target:
                if math.isinf(bound):
                    return prev_b  # last finite bound, like Prometheus
                if cum <= prev_c:
                    return bound
                lo = prev_b if prev_c > 0 or bound <= 0 else 0.0
                return lo + (bound - lo) * (target - prev_c) \
                    / (cum - prev_c)
            prev_b, prev_c = bound, cum
        return prev_b

    def rates(self, window_s: Optional[float] = None) -> Dict[str, float]:
        """{``name{label=v,...}``: per-second rate} for every COUNTER
        series with enough history — the ``/statusz`` movement view.
        Histogram ``_bucket`` series are left out (a 16-bound grid per
        histogram would drown the page; read them via
        :meth:`quantile`)."""
        with self._lock:
            keys = list(self._series)
            kinds = dict(self._kinds)
        out: Dict[str, float] = {}
        for name, labels in keys:
            if kinds.get(name) != "counter" or name.endswith("_bucket"):
                continue
            r = self.rate(name, window_s, **dict(labels))
            if r is None:
                continue
            lbl = ",".join(f"{k}={v}" for k, v in labels)
            out[f"{name}{{{lbl}}}" if lbl else name] = r
        return out

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._kinds.clear()
            self.snapshots_taken = 0


# ---------------------------------------------------------------------------
# Prometheus text parsing (the monitor_top scrape path)
# ---------------------------------------------------------------------------

_TYPE_RE = re.compile(r"^# TYPE (\S+) (\S+)$")
_SAMPLE_RE = re.compile(
    rf"^({_L_METRIC_NAME})"
    r"(?:\{(.*?)\})?"
    rf" ({_L_NUM})"
    r"(?: [+-]?[0-9]+)?"
    r"(?: # .*)?$")
_LABEL_RE = re.compile(
    rf'({_L_LABEL_NAME})="((?:[^"\\]|\\.)*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    """Single-pass inverse of the exposition label escaping: sequential
    str.replace cannot decode this (``\\\\`` followed by a literal
    ``n`` would be misread as ``\\n``); a scanner consumes each escape
    pair exactly once. Unknown escapes pass through literally."""
    return _UNESCAPE_RE.sub(
        lambda m: {"\\": "\\", '"': '"', "n": "\n"}.get(
            m.group(1), m.group(0)), v)


def parse_prometheus(text: str) -> List[dict]:
    """Parse a text exposition page into rows shaped like
    ``load_jsonl`` output: ``{name, type, labels, value}``. Histogram
    samples come back as their flattened ``_count``/``_sum``/``_bucket``
    counter rows (a fleet federator and :meth:`quantile`
    need the bucket grid); exemplar suffixes are ignored; unparseable
    lines are skipped (a scrape of a foreign process must degrade, not
    crash)."""
    rows: List[dict] = []
    kinds: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                kinds[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labelstr, value = m.group(1), m.group(2), m.group(3)
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labelstr or "")}
        kind = kinds.get(name)
        if kind is None:
            for suffix in ("_bucket", "_count", "_sum"):
                if name.endswith(suffix) and \
                        kinds.get(name[:-len(suffix)]) == "histogram":
                    kind = "counter"
                    break
        try:
            rows.append({"name": name, "type": kind or "gauge",
                         "labels": labels, "value": float(value)})
        except ValueError:
            continue
    return rows
