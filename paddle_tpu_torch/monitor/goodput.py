"""Training goodput ledger — where every second of trainer wall-clock went.

The training-side counterpart of the serving observability plane
(docs/OBSERVABILITY.md): a :class:`GoodputLedger` attributes elapsed
wall-clock to exactly one of a small set of EXCLUSIVE buckets — the
Google ML-Goodput / MegaScale accounting model, where

    goodput% = productive_dispatch / elapsed

and every non-productive second is named (compile, data wait, checkpoint
stall, nonfinite rollback, restart gap, host other). Instrumentation
rides seams that already exist:

- ``ops.kernels.build()``          → ``compile``. The port has no XLA
  compile: its compile time is the first-use ``nvcc`` build of the
  kernel libraries (seconds each, all sources at once), so that is what
  this bucket holds
- ``TrainStep`` dispatch           → ``productive_dispatch`` (a dispatch
  that RAISES is badput and folds into ``host_other``)
- the nonfinite watchdog trip path → ``nonfinite_rollback`` (the failed
  step's dispatch interval is re-attributed: a rolled-back update made
  no progress)
- dataloader ``next()``            → ``data_wait`` (the last wait is
  also attached as a ``data_wait`` span on the next ``train.step``
  trace)
- ``distributed.checkpoint.CheckpointManager`` saves and waits →
  ``checkpoint_stall``; its ``resume()`` restores the saved ledger
  (``state()``/``restore()``, the sidecar), which attributes the dead
  time since the last commit to ``restart_gap``

``host_other`` is DERIVED — the residual ``elapsed - sum(measured)`` —
so the exhaustiveness invariant (bucket seconds sum to elapsed
wall-clock) holds by construction and is pinned by test. Exclusivity is
enforced by a monotonic cursor: overlapping/nested measures never
double-count a wall-clock second.

Zero-overhead contract (``FLAGS_train_goodput`` unset, the default):
:func:`measure` is one flag read and a no-op yield — no ledger object
is ever allocated (``GOODPUT_STATS['ledgers_allocated']`` stays 0, the
pin tests/test_torch_monitor.py reads), no registry series appear, and the
step launches exactly what it launched without the ledger.

Port of ``paddle_tpu/monitor/goodput.py``: the same buckets, the same
exclusive attribution and the same metric names.

Per-layer model health (``FLAGS_train_health_every=N``) lives with the
ledger because both answer "is this run healthy": TrainStep computes
per-layer grad-norm / param-norm / update-ratio f32 values on every Nth
step and publishes them through :func:`note_layer_health`;
the :class:`LayerHealthMonitor` EWMA spike detector here tail-marks the
step trace (``ANOMALY_REASONS`` entry ``health_spike``) and the last
health vector joins every flight-recorder dump.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "BUCKETS", "BADPUT_BUCKETS", "GOODPUT_STATS", "GoodputLedger",
    "LayerHealthMonitor", "active", "active_ledger", "get_ledger",
    "measure", "note_layer_health", "last_layer_health", "reset",
    "statusz_section",
]

#: the exclusive wall-clock buckets; every elapsed second lands in
#: exactly one (docs/OBSERVABILITY.md "Training goodput & model health"
#: has the taxonomy table)
BUCKETS = ("productive_dispatch", "compile", "data_wait",
           "checkpoint_stall", "nonfinite_rollback", "restart_gap",
           "host_other")

#: everything that is not productive — the label set of
#: ``train_badput_seconds_total{bucket}``
BADPUT_BUCKETS = tuple(b for b in BUCKETS if b != "productive_dispatch")

#: allocation probe: the zero-overhead pin reads ledgers_allocated == 0
#: with FLAGS_train_goodput off (tests/test_torch_monitor.py)
GOODPUT_STATS = {"ledgers_allocated": 0, "intervals_accounted": 0,
                 "reattributions": 0, "restores": 0}


class GoodputLedger:
    """Exclusive wall-clock accounting for one training process.

    Time is measured on ``time.perf_counter`` (interval arithmetic);
    persistence stamps ``time.time`` wall time so a restart can compute
    the cross-process gap. Thread-safe: the dataloader prefetcher and
    the training loop may account concurrently.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._start = time.perf_counter()
        # measured seconds THIS process; host_other only accrues here
        # via the on_error path of measure() — its main mass is the
        # derived residual added in snapshot()
        self._seconds: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        # restored from a previous incarnation's sidecar state (plus the
        # restart gap); snapshot() adds carry and live per bucket
        self._carry: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._carry_elapsed = 0.0
        self._restarts = 0
        # exclusivity cursor: no accounted interval may start before it
        self._cursor = self._start
        # (bucket, seconds) of the last closed interval — the nonfinite
        # watchdog re-attributes the failed step's dispatch through this
        self._last: Optional[Tuple[str, float]] = None
        # last closed data_wait interval (perf_counter t0/t1) awaiting
        # attachment as a span on the next train.step trace
        self._pending_data_wait: Optional[Tuple[float, float]] = None
        # per-bucket seconds already inc'd into the registry counter —
        # publish() emits deltas so the counter stays monotonic
        self._published: Dict[str, float] = {b: 0.0 for b in BUCKETS}

    # -- accounting --------------------------------------------------------
    def _account(self, bucket: str, t0: float, t1: float) -> None:
        if bucket not in self._seconds:
            raise ValueError(f"unknown goodput bucket {bucket!r}; "
                             f"expected one of {BUCKETS}")
        with self._lock:
            t0 = max(t0, self._cursor)
            if t1 <= t0:
                return
            dur = t1 - t0
            self._seconds[bucket] += dur
            self._cursor = t1
            self._last = (bucket, dur)
            GOODPUT_STATS["intervals_accounted"] += 1

    @contextlib.contextmanager
    def measure(self, bucket: str, on_error: Optional[str] = None):
        """Attribute the body's wall time to ``bucket`` (or to
        ``on_error`` when the body raises — a dispatch that died is not
        productive time). Nesting-safe: the exclusivity cursor clips any
        overlap with an interval already accounted."""
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            self._account(on_error or bucket, t0, time.perf_counter())
            raise
        t1 = time.perf_counter()
        self._account(bucket, t0, t1)
        if bucket == "data_wait":
            with self._lock:
                self._pending_data_wait = (t0, t1)

    def reattribute_last(self, to_bucket: str) -> float:
        """Move the most recently closed interval into ``to_bucket`` —
        the nonfinite rollback path: the step's dispatch seconds were
        provisionally productive, but a rolled-back update made no
        progress. Returns the seconds moved (0.0 when there is no
        closed interval to move)."""
        if to_bucket not in self._seconds:
            raise ValueError(f"unknown goodput bucket {to_bucket!r}")
        with self._lock:
            if self._last is None:
                return 0.0
            bucket, dur = self._last
            if bucket != to_bucket:
                self._seconds[bucket] -= dur
                self._seconds[to_bucket] += dur
                GOODPUT_STATS["reattributions"] += 1
            self._last = (to_bucket, dur)
            return dur

    def pop_pending_data_wait(self) -> Optional[Tuple[float, float]]:
        """The last closed ``data_wait`` interval as perf_counter
        ``(t0, t1)`` — same clock domain as the structured tracer, so
        TrainStep can attach it as an explicit-timestamp span on the
        step trace. Cleared on read."""
        with self._lock:
            dw, self._pending_data_wait = self._pending_data_wait, None
            return dw

    # -- views -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe totals: per-bucket seconds (carry + live, with
        ``host_other`` absorbing the unmeasured residual), total elapsed
        and ``goodput_pct``. Sum of buckets == elapsed by construction."""
        with self._lock:
            now = time.perf_counter()
            live_elapsed = now - self._start
            measured = sum(self._seconds.values())
            residual = max(0.0, live_elapsed - measured)
            buckets = {b: self._seconds[b] + self._carry[b]
                       for b in BUCKETS}
            buckets["host_other"] += residual
            elapsed = live_elapsed + self._carry_elapsed
            good = buckets["productive_dispatch"]
            return {
                "elapsed_s": elapsed,
                "goodput_pct": (100.0 * good / elapsed) if elapsed > 0
                else 0.0,
                "restarts": self._restarts,
                "buckets": buckets,
            }

    # -- persistence (CheckpointManager sidecar) ---------------------------
    def state(self) -> dict:
        """Snapshot plus a wall-clock stamp — the JSON the
        CheckpointManager sidecar carries so ``goodput_pct`` survives
        SIGTERM → resume. Floats are kept at full precision: restore is
        bit-consistent."""
        s = self.snapshot()
        s["wall"] = time.time()
        s["version"] = 1
        return s

    def restore(self, state: dict) -> float:
        """Fold a previous incarnation's :meth:`state` into this
        ledger's carry and attribute the dead time since its wall stamp
        (minus what this process has already lived and accounted) to
        ``restart_gap``. Returns the gap seconds added."""
        with self._lock:
            live = time.perf_counter() - self._start
            gap = max(0.0, time.time() - float(state.get("wall", 0.0))
                      - live)
            if not state.get("wall"):
                gap = 0.0
            saved = state.get("buckets") or {}
            for b in BUCKETS:
                self._carry[b] += float(saved.get(b, 0.0))
            self._carry["restart_gap"] += gap
            self._carry_elapsed += float(state.get("elapsed_s", 0.0)) + gap
            self._restarts = int(state.get("restarts", 0)) + 1
            GOODPUT_STATS["restores"] += 1
            return gap

    # -- registry ----------------------------------------------------------
    def publish(self, registry=None) -> None:
        """Publish ``train_goodput_pct`` (gauge) and per-bucket
        ``train_badput_seconds_total`` counter DELTAS since the last
        publish — monotonic within a process, and the first publish
        after a restore carries the restored totals forward (the
        cross-restart aggregate stays monotonic under the registry's
        counter-merge convention)."""
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        snap = self.snapshot()
        registry.gauge(
            "train_goodput_pct",
            "productive dispatch share of trainer wall-clock (the ML "
            "Goodput headline; buckets in train_badput_seconds_total)"
        ).set(snap["goodput_pct"])
        with self._lock:
            ctr = registry.counter(
                "train_badput_seconds_total",
                "non-productive trainer wall-clock by exclusive bucket "
                "(GoodputLedger)")
            for b in BADPUT_BUCKETS:
                delta = snap["buckets"][b] - self._published[b]
                if delta > 0:
                    ctr.inc(delta, bucket=b)
                    self._published[b] = snap["buckets"][b]


class LayerHealthMonitor:
    """EWMA spike detector over per-layer gradient norms.

    ``observe()`` takes the host-side health vector TrainStep publishes
    ({layer: {"grad_norm", "param_norm", "update_ratio"}}) and returns
    the layers whose grad norm spiked — value above ``factor`` × its
    EWMA after ``warmup`` observations, or non-finite at any point. The
    caller tail-marks the step trace (reason ``health_spike``) and
    bumps ``train_health_spikes_total``.
    """

    def __init__(self, alpha: float = 0.3, factor: float = 10.0,
                 warmup: int = 5):
        self.alpha = float(alpha)
        self.factor = float(factor)
        self.warmup = int(warmup)
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def observe(self, health: Dict[str, dict]) -> List[str]:
        spikes = []
        for layer, vals in health.items():
            g = float(vals.get("grad_norm", 0.0))
            if not math.isfinite(g):
                spikes.append(layer)
                continue
            n = self._count.get(layer, 0)
            e = self._ewma.get(layer)
            if (n >= self.warmup and e is not None
                    and g > self.factor * max(e, 1e-30)):
                spikes.append(layer)
                # a spike does not poison the baseline: the EWMA keeps
                # tracking so a genuine regime change re-arms after a
                # few steps instead of alerting forever
            self._ewma[layer] = g if e is None \
                else (1.0 - self.alpha) * e + self.alpha * g
            self._count[layer] = n + 1
        return spikes


# -- module-global plumbing (lazy: nothing allocates while the flag is
#    off — the zero-overhead pin) -----------------------------------------

_LEDGER: Optional[GoodputLedger] = None
_LAST_HEALTH: Optional[dict] = None
_HEALTH_PROVIDER_REGISTERED = False


def active() -> bool:
    """True when ``FLAGS_train_goodput`` is set."""
    from ..core.flags import get_flag
    return bool(get_flag("train_goodput"))


def get_ledger() -> Optional[GoodputLedger]:
    """The process ledger if one has been allocated (flag may have been
    turned off since); None otherwise. Never allocates."""
    return _LEDGER


def active_ledger() -> Optional[GoodputLedger]:
    """The process ledger when ``FLAGS_train_goodput`` is on (allocated
    lazily on first use), else None. The flag read comes FIRST: with the
    flag off this is one dict lookup and no allocation, ever."""
    if not active():
        return None
    global _LEDGER
    if _LEDGER is None:
        _LEDGER = GoodputLedger()
        GOODPUT_STATS["ledgers_allocated"] += 1
        from . import flight_recorder as _fr
        _fr.register_dump_provider("goodput", _dump_provider)
        # join a live admin plane if one is already up; TrainStep's
        # monitor_port path registers the section at server start too
        import sys
        srv_mod = sys.modules.get(__package__ + ".server")
        if srv_mod is not None:
            srv = srv_mod.get_server()
            if srv is not None:
                srv.register_status("goodput", statusz_section)
    return _LEDGER


@contextlib.contextmanager
def measure(bucket: str, on_error: Optional[str] = None):
    """Module-level :meth:`GoodputLedger.measure` that is a no-op (one
    flag read) when ``FLAGS_train_goodput`` is off — the form every
    instrumentation seam uses."""
    led = active_ledger()
    if led is None:
        yield
        return
    with led.measure(bucket, on_error=on_error):
        yield


def statusz_section():
    """/statusz section provider: the ledger snapshot, or None (section
    skipped) while the flag is off / no ledger exists."""
    led = _LEDGER
    if led is None or not active():
        return None
    return led.snapshot()


def _dump_provider():
    """Flight-recorder attachment: goodput totals travel with every
    crash dump."""
    return statusz_section()


def note_layer_health(health: dict, step: Optional[int] = None) -> None:
    """Record the latest host-side per-layer health vector (TrainStep
    calls this at each publish cadence) and attach it to future
    flight-recorder dumps under ``layer_health``."""
    global _LAST_HEALTH, _HEALTH_PROVIDER_REGISTERED
    _LAST_HEALTH = {"step": step, "layers": health}
    if not _HEALTH_PROVIDER_REGISTERED:
        from . import flight_recorder as _fr
        _fr.register_dump_provider("layer_health", last_layer_health)
        _HEALTH_PROVIDER_REGISTERED = True


def last_layer_health() -> Optional[dict]:
    """The most recently published per-layer health vector
    (``{"step", "layers": {layer: {grad_norm, param_norm,
    update_ratio}}}``), or None."""
    return _LAST_HEALTH


def reset() -> None:
    """Drop all module state (tests; conftest autouse isolation)."""
    global _LEDGER, _LAST_HEALTH, _HEALTH_PROVIDER_REGISTERED
    _LEDGER = None
    _LAST_HEALTH = None
    _HEALTH_PROVIDER_REGISTERED = False
    for k in GOODPUT_STATS:
        GOODPUT_STATS[k] = 0
    import sys
    fr = sys.modules.get(__package__ + ".flight_recorder")
    if fr is not None:
        fr._DUMP_PROVIDERS.pop("goodput", None)
        fr._DUMP_PROVIDERS.pop("layer_health", None)
