"""Structured metrics registry: Counter / Gauge / Histogram with labels.

The framework-wide telemetry store (reference analogue: the per-op stat
tables of platform/profiler.cc plus the monitoring counters scattered
through fluid — here unified in one process-global registry, the way the
reference's device_tracer aggregates everything the timeline needs).

Design:
- three metric kinds — Counter (monotonic), Gauge (set-to-value),
  Histogram (bucketed observations with sum/count) — each supporting
  free-form string labels (``reg.counter("comm_bytes_total").inc(4096,
  op="all_reduce", group="dp")``);
- one process-global default registry (:func:`get_registry`) plus
  :func:`scoped_registry` for tests that need isolation;
- two export formats: Prometheus text exposition
  (:meth:`MetricsRegistry.to_prometheus`) and append-only JSONL
  (:meth:`MetricsRegistry.dump_jsonl`, rendered by
  ``tools/monitor_report.py``);
- every mutation bumps :attr:`MetricsRegistry.write_count`, which is how
  the zero-overhead guarantee of the monitor-off hot path is pinned in
  tests (no per-step registry writes unless ``FLAGS_monitor`` is on).

All operations are thread-safe (one RLock per registry; eager-op threads,
the DataLoader workers, and the async checkpoint thread may all write).

A copy of ``paddle_tpu/monitor/metrics.py``, which imports no JAX: the
same operations give the same Prometheus text and JSONL records in both
packages (tests/test_torch_monitor.py).
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "scoped_registry", "load_jsonl",
    "load_registry_jsonl", "lint_exposition",
]

# Prometheus' default latency buckets (seconds), the right shape for both
# host-side step timings (ms..s) and eager dispatch (sub-ms).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    """Label-VALUE escaping per the Prometheus text exposition spec:
    backslash, double-quote and newline (in that order — escaping the
    escapes first, or a pre-escaped ``\\n`` would double)."""
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: the spec escapes ONLY backslash and newline
    there (quotes are legal in prose). An unescaped newline would smear
    the rest of the help string into a bogus sample line — the
    unscrapeable-page failure mode the conformance lint exists for."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(key: _LabelKey, extra: Optional[Tuple[Tuple[str, str], ...]]
                = None) -> str:
    items = list(key) + list(extra or ())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._reg = registry
        self._lock = registry._lock
        self._series: Dict[_LabelKey, Any] = {}

    def samples(self) -> List[Tuple[Dict[str, str], Any]]:
        """[(labels_dict, value), ...] — value is a float for counter/gauge,
        a dict for histograms."""
        with self._lock:
            return [(dict(k), self._export(v))
                    for k, v in self._series.items()]

    def _export(self, v):
        return v

    def labels_seen(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in self._series]


class Counter(_Metric):
    """Monotonic counter (Prometheus semantics: only goes up)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{value} (use a Gauge)")
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value
            self._reg._write_count += 1

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Set-to-current-value metric (queue depth, loss scale, cache size)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)
            self._reg._write_count += 1

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value
            self._reg._write_count += 1

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Bucketed observations with cumulative sum/count per label set."""

    kind = "histogram"

    def __init__(self, name, help, registry, buckets=None):
        super().__init__(name, help, registry)
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not bs:
            raise ValueError(f"histogram {self.name}: needs >= 1 bucket")
        self.buckets = bs

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        """Record one observation. ``exemplar`` (OpenMetrics exemplars:
        a trace_id) is attached to the bucket the value lands in — the
        newest exemplar per bucket wins — so a p99 bucket links to a
        CONCRETE trace (docs/OBSERVABILITY.md "Structured tracing")."""
        k = _label_key(labels)
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = {"counts": [0] * len(self.buckets), "sum": 0.0,
                      "count": 0}
                self._series[k] = st
            bucket = None
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["counts"][i] += 1
                    bucket = b
                    break
            st["sum"] += float(value)
            st["count"] += 1
            if exemplar is not None:
                # keyed by the bucket's upper bound ("+Inf" past the
                # last) — the join key readers use against `buckets`
                st.setdefault("exemplars", {})[
                    repr(float(bucket)) if bucket is not None
                    else "+Inf"] = {
                        "trace_id": str(exemplar),
                        "value": float(value), "ts": time.time()}
            self._reg._write_count += 1

    def _export(self, st) -> dict:
        # cumulative-`le` form, the shape both exporters serialize
        cum, acc = [], 0
        for b, c in zip(self.buckets, st["counts"]):
            acc += c
            cum.append([b, acc])
        out = {"count": st["count"], "sum": st["sum"], "buckets": cum}
        if st.get("exemplars"):
            out["exemplars"] = {le: dict(ex)
                                for le, ex in st["exemplars"].items()}
        return out

    def exemplars(self, **labels) -> Dict[str, dict]:
        """{le: {trace_id, value, ts}} for one label set (empty when no
        exemplar-carrying observation landed)."""
        with self._lock:
            st = self._series.get(_label_key(labels))
            return ({le: dict(ex)
                     for le, ex in st.get("exemplars", {}).items()}
                    if st else {})

    def count(self, **labels) -> int:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return int(st["count"]) if st else 0

    def sum(self, **labels) -> float:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return float(st["sum"]) if st else 0.0

    def mean(self, **labels) -> float:
        with self._lock:
            st = self._series.get(_label_key(labels))
            return float(st["sum"] / st["count"]) if st and st["count"] \
                else 0.0


class MetricsRegistry:
    """Named collection of metrics with get-or-create accessors."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._write_count = 0

    # -- accessors ---------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        if self.namespace:
            name = f"{self.namespace}_{name}"
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    @property
    def write_count(self) -> int:
        """Monotonic count of metric mutations — the overhead-guard probe:
        the monitor-off hot path must leave this unchanged per step."""
        with self._lock:
            return self._write_count

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """{name: {type, help, samples: [(labels, value), ...]}} — values
        are plain python (floats / histogram dicts), safe to json-encode."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"type": m.kind, "help": m.help,
                         "samples": m.samples()} for m in metrics}

    def to_prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format (v0.0.4). With
        ``exemplars=True``, histogram exemplars render in the
        OpenMetrics ``# {trace_id="..."}`` suffix syntax on the bucket
        they landed in — the link from a p99 bucket to a concrete
        structured trace. The suffix is only legal in OpenMetrics
        responses (classic text/plain parsers reject it and fail the
        whole page), so it is OFF by default and the admin server
        enables it only on Accept-negotiated scrapes. HELP text and
        label values are escaped per the exposition spec (a stray
        ``"`` or newline in a label must never produce an unscrapeable
        page); :func:`lint_exposition` checks the emitted grammar."""
        lines: List[str] = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]

        def exemplar_suffix(value: dict, le_key: str) -> str:
            if not exemplars:
                return ""
            ex = (value.get("exemplars") or {}).get(le_key)
            if not ex:
                return ""
            return (f' # {{trace_id="{_escape(str(ex["trace_id"]))}"}} '
                    f'{ex["value"]} {ex["ts"]:.3f}')

        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, value in m.samples():
                key = _label_key(labels)
                if m.kind == "histogram":
                    for le, cum in value["buckets"]:
                        le_key = repr(float(le))
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(key, (('le', le_key),))}"
                            f" {cum}"
                            f"{exemplar_suffix(value, le_key)}")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(key, (('le', '+Inf'),))}"
                        f" {value['count']}"
                        f"{exemplar_suffix(value, '+Inf')}")
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} "
                                 f"{value['sum']}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} "
                                 f"{value['count']}")
                else:
                    lines.append(f"{m.name}{_fmt_labels(key)} {value}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- multi-host aggregation --------------------------------------------
    def _raw_metric(self, name: str, kind: str, help: str = "",
                    buckets=None) -> _Metric:
        """Get-or-create by FULL name (no namespace prefixing) — the
        merge/loader path, where incoming names are already final."""
        cls = {"counter": Counter, "gauge": Gauge,
               "histogram": Histogram}[kind]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                kw = {"buckets": buckets} if kind == "histogram" else {}
                m = cls(name, help, self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"merge brings {kind}")
            return m

    def merge(self, other: "MetricsRegistry",
              host: Optional[str] = None) -> None:
        """Fold ``other``'s series into this registry — the multi-host
        aggregation primitive behind ``tools/aggregate_metrics.py``
        (per-host JSONL registries → ONE exposition):

        - **counters** sum per label set (restart-safe: each process
          segment's total contributes once, so the merged series stays
          monotonic across a host restart);
        - **gauges** are last-write-wins; with ``host`` given, every
          incoming gauge series gains a ``host=<host>`` label so
          per-host values stay distinguishable instead of silently
          clobbering each other;
        - **histograms** merge bucket-wise (per-bucket counts, sum and
          count add). CONFLICTING bucket boundaries raise ValueError —
          adding counts across different ``le`` grids would silently
          corrupt every quantile read off the merged series;
        - histogram **exemplars** keep the newest per bucket (ts wins).
        """
        if other is self:
            return
        with other._lock:
            metrics = list(other._metrics.values())
        for m in metrics:
            with other._lock:
                series = {k: (dict(v) if isinstance(v, dict) else v)
                          for k, v in m._series.items()}
            mine = self._raw_metric(
                m.name, m.kind, m.help,
                buckets=getattr(m, "buckets", None))
            if m.kind == "histogram" and mine.buckets != m.buckets:
                raise ValueError(
                    f"histogram {m.name!r}: conflicting bucket "
                    f"boundaries {mine.buckets} vs {m.buckets} — "
                    "refusing to mis-merge (re-record with one bucket "
                    "layout, or rename the series)")
            with self._lock:
                for k, v in series.items():
                    if m.kind == "counter":
                        mine._series[k] = mine._series.get(k, 0.0) \
                            + float(v)
                    elif m.kind == "gauge":
                        key = (k if host is None else _label_key(
                            dict(dict(k), host=str(host))))
                        mine._series[key] = float(v)
                    else:
                        dst = mine._series.get(k)
                        if dst is None:
                            dst = {"counts": [0] * len(mine.buckets),
                                   "sum": 0.0, "count": 0}
                            mine._series[k] = dst
                        for i, c in enumerate(v["counts"]):
                            dst["counts"][i] += c
                        dst["sum"] += float(v["sum"])
                        dst["count"] += int(v["count"])
                        for le, ex in (v.get("exemplars") or {}).items():
                            cur = dst.setdefault("exemplars", {}).get(le)
                            if cur is None or ex.get("ts", 0.0) \
                                    >= cur.get("ts", 0.0):
                                dst["exemplars"][le] = dict(ex)
                    self._write_count += 1

    def dump_jsonl(self, path: str, extra: Optional[dict] = None) -> str:
        """Append one JSON line per (metric, label-set) sample.

        Append-only by design: successive dumps (per epoch, per bench run)
        accumulate; readers take the newest sample per (name, labels) —
        see tools/monitor_report.py. ``extra`` keys (epoch, tag, source)
        are merged into every line."""
        ts = time.time()
        base = dict(extra or {})
        with open(path, "a") as f:
            for name, info in self.snapshot().items():
                for labels, value in info["samples"]:
                    line = dict(base, ts=round(ts, 3), name=name,
                                type=info["type"], labels=labels)
                    if info["type"] == "histogram":
                        line.update(count=value["count"], sum=value["sum"],
                                    buckets=value["buckets"])
                        if value.get("exemplars"):
                            line["exemplars"] = value["exemplars"]
                    else:
                        line["value"] = value
                    f.write(json.dumps(line) + "\n")
        return path


def load_jsonl(path: str) -> List[dict]:
    """Parse a registry JSONL dump; skips malformed lines (a crashed
    writer must not make the whole record unreadable)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(d, dict) and "name" in d:
                out.append(d)
    return out


def load_registry_jsonl(path: str,
                        registry: Optional[MetricsRegistry] = None) \
        -> MetricsRegistry:
    """Rebuild a :class:`MetricsRegistry` from a ``dump_jsonl`` stream.

    Gauges take the NEWEST sample per (name, labels); counters and
    histograms ACCUMULATE across restart segments *within* the file —
    an append-only stream whose value drops mid-file means the writer
    restarted, and the pre-restart segment's total still happened, so
    it contributes once and the loaded total stays monotonic (the same
    restart contract :meth:`MetricsRegistry.merge` gives across
    files). Histogram bucket boundaries must stay consistent within
    the file (and with any metric already in ``registry``) — a change
    raises rather than mis-merging; exemplars come from the newest
    segment. The input half of ``tools/aggregate_metrics.py``."""
    acc: Dict[Tuple[str, _LabelKey], dict] = {}
    for row in load_jsonl(path):
        name = row["name"]
        kind = row.get("type", "gauge")
        key = (name, tuple(sorted((k, str(v)) for k, v in
                                  (row.get("labels") or {}).items())))
        if kind == "counter":
            v = float(row.get("value", 0.0))
            st = acc.get(key)
            if st is None:
                acc[key] = {"kind": kind, "base": 0.0, "last": v}
            else:
                if v < st["last"]:           # restart: bank the segment
                    st["base"] += st["last"]
                st["last"] = v
        elif kind == "histogram":
            buckets = tuple(float(le)
                            for le, _ in (row.get("buckets") or []))
            if not buckets:
                continue               # empty histogram: nothing to keep
            counts, prev = [], 0
            for _, cum in row["buckets"]:
                counts.append(int(cum) - prev)
                prev = int(cum)
            seg = {"counts": counts, "sum": float(row.get("sum", 0.0)),
                   "count": int(row.get("count", 0)),
                   "exemplars": {le: dict(ex) for le, ex in
                                 (row.get("exemplars") or {}).items()}}
            st = acc.get(key)
            if st is None:
                acc[key] = {"kind": kind, "buckets": buckets,
                            "base": {"counts": [0] * len(buckets),
                                     "sum": 0.0, "count": 0},
                            "last": seg}
            else:
                if buckets != st["buckets"]:
                    raise ValueError(
                        f"histogram {name!r}: bucket boundaries "
                        f"changed mid-file in {path} ({st['buckets']} "
                        f"-> {buckets}) — refusing to mis-merge")
                if seg["count"] < st["last"]["count"]:
                    base = st["base"]
                    for i, c in enumerate(st["last"]["counts"]):
                        base["counts"][i] += c
                    base["sum"] += st["last"]["sum"]
                    base["count"] += st["last"]["count"]
                st["last"] = seg
        else:                              # gauge: newest wins
            acc[key] = {"kind": "gauge",
                        "value": float(row.get("value", 0.0))}
    reg = registry if registry is not None else MetricsRegistry()
    for (name, labels), st in sorted(acc.items()):
        kind = st["kind"]
        if kind == "histogram":
            m = reg._raw_metric(name, kind, buckets=list(st["buckets"]))
            if st["buckets"] != m.buckets:
                raise ValueError(
                    f"histogram {name!r}: {path} carries bucket "
                    f"boundaries {st['buckets']} but the registry "
                    f"already holds {m.buckets} — refusing to mis-merge")
            base, last = st["base"], st["last"]
            out = {"counts": [b + c for b, c in zip(base["counts"],
                                                    last["counts"])],
                   "sum": base["sum"] + last["sum"],
                   "count": base["count"] + last["count"]}
            if last["exemplars"]:
                out["exemplars"] = last["exemplars"]
            with reg._lock:
                m._series[labels] = out
                reg._write_count += 1
        else:
            m = reg._raw_metric(name, kind)
            value = (st["base"] + st["last"] if kind == "counter"
                     else st["value"])
            with reg._lock:
                m._series[labels] = value
                reg._write_count += 1
    return reg


# ---------------------------------------------------------------------------
# Exposition conformance lint
# ---------------------------------------------------------------------------

_L_METRIC_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_L_LABEL_NAME = r"[a-zA-Z_][a-zA-Z0-9_]*"
#: a quoted label value: no raw ", \ or newline; escapes limited to
#: \\ \" \n (the spec's set — anything else is an invalid escape)
_L_LABEL_VALUE = r'"(?:[^"\\\n]|\\["\\n])*"'
_L_LABELS = (rf"\{{{_L_LABEL_NAME}={_L_LABEL_VALUE}"
             rf"(?:,{_L_LABEL_NAME}={_L_LABEL_VALUE})*,?\}}")
_L_NUM = r"[+-]?(?:[0-9]+(?:\.[0-9]*)?(?:[eE][+-]?[0-9]+)?|\.[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN)"
#: OpenMetrics exemplar suffix: ` # {labels} value [ts]`
_L_EXEMPLAR = rf" # {_L_LABELS} {_L_NUM}(?: {_L_NUM})?"
_L_SAMPLE_RE = re.compile(
    rf"^({_L_METRIC_NAME})(?:{_L_LABELS})? {_L_NUM}"
    rf"(?: [+-]?[0-9]+)?(?:{_L_EXEMPLAR})?$")
_L_HELP_RE = re.compile(rf"^# HELP ({_L_METRIC_NAME}) (.*)$")
_L_TYPE_RE = re.compile(
    rf"^# TYPE ({_L_METRIC_NAME}) "
    r"(counter|gauge|histogram|summary|untyped)$")
def _bad_help_escape(text: str) -> bool:
    """True when HELP text contains an escape other than ``\\\\`` /
    ``\\n`` (scanned non-overlapping, so ``\\\\`` consumes both chars
    and a following literal char is not misread as an escape)."""
    return any(m.group(1) not in ("\\", "n")
               for m in re.finditer(r"\\(.?)", text))


def lint_exposition(text: str) -> List[str]:
    """Grammar-lint a Prometheus/OpenMetrics text page line by line;
    returns human-readable problems (empty list = scrapeable). This is
    the conformance gate behind ``/metrics`` and the exposition tests:
    every emitted line must parse as a HELP/TYPE comment or a sample
    (optionally exemplar-suffixed), label values must use only the
    spec's escape sequences, and sample names must belong to a
    TYPE-declared family (histogram samples may carry the
    ``_bucket``/``_sum``/``_count`` suffixes)."""
    problems: List[str] = []
    typed: Dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            mh = _L_HELP_RE.match(line)
            if mh:
                if _bad_help_escape(mh.group(2)):
                    problems.append(
                        f"line {i}: invalid escape in HELP text "
                        f"(only \\\\ and \\n are legal): {line!r}")
                continue
            mt = _L_TYPE_RE.match(line)
            if mt:
                name = mt.group(1)
                if name in typed:
                    problems.append(
                        f"line {i}: duplicate TYPE for {name!r}")
                typed[name] = mt.group(2)
                continue
            if line.startswith(("# HELP", "# TYPE")):
                problems.append(f"line {i}: malformed HELP/TYPE comment: "
                                f"{line!r}")
            continue                        # free-form comments are legal
        ms = _L_SAMPLE_RE.match(line)
        if ms is None:
            problems.append(f"line {i}: unparseable sample line: "
                            f"{line!r}")
            continue
        name = ms.group(1)
        if typed:
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and \
                        name[:-len(suffix)] in typed:
                    family = name[:-len(suffix)]
                    break
            if family not in typed:
                problems.append(
                    f"line {i}: sample {name!r} has no TYPE declaration")
            elif family != name and typed[family] not in ("histogram",
                                                          "summary"):
                problems.append(
                    f"line {i}: {name!r} uses a histogram suffix but "
                    f"{family!r} is typed {typed[family]}")
    return problems


# ---------------------------------------------------------------------------
# Default + scoped registries
# ---------------------------------------------------------------------------

_default_registry = MetricsRegistry()
_registry_stack: List[MetricsRegistry] = []


def get_registry() -> MetricsRegistry:
    """The active registry: the innermost :func:`scoped_registry` if one is
    open, else the process-global default."""
    return _registry_stack[-1] if _registry_stack else _default_registry


@contextlib.contextmanager
def scoped_registry(registry: Optional[MetricsRegistry] = None) \
        -> Iterator[MetricsRegistry]:
    """Route :func:`get_registry` to a fresh (or given) registry for the
    with-block — test isolation without touching the process-global one."""
    reg = registry if registry is not None else MetricsRegistry()
    _registry_stack.append(reg)
    try:
        yield reg
    finally:
        _registry_stack.pop()
