"""SLO error-budget burn rate: multi-window gauges over serving
outcomes (the alerting-ready companion to an overload detector).
A copy of ``paddle_tpu/monitor/slo.py``, which imports no JAX: the port
keeps its own.

An SLO is an objective over a compliance period — "99.9% of requests
complete" over 30 days. The **error budget** is the allowed failure
fraction (``1 - objective``); the **burn rate** is how fast current
traffic spends it::

    burn_rate(window) = error_ratio(window) / (1 - objective)

Burn 1.0 = exactly on budget (the budget lasts the whole period);
burn 14.4 on a 99.9% SLO = the month's budget gone in ~2 days. The
Google SRE-workbook alerting recipe pairs a LONG window (is it real?)
with a SHORT one (is it still happening?) at the same threshold —
:meth:`SLOTracker.should_alert` implements exactly that, and
:meth:`SLOTracker.publish` exports ``slo_burn_rate{slo,window}`` /
``slo_error_budget_remaining{slo}`` gauges for dashboards.

:class:`SLOTracker` is pure host-side arithmetic over a bounded ring of
time buckets (injectable clock — the tests drive it deterministically).
The serving engine feeds two trackers when ``ServingConfig.slo_*``
objectives are set (off by default: zero tracker allocations, zero
registry writes — docs/SERVING.md):

- **availability**: good = completed; bad = expired / failed / shed
  (cancelled and drained are client/operator choices, not failures);
- **deadline**: good = completed with non-negative deadline slack;
  bad = completed late or expired in flight — fed from the same
  boundary that observes ``serve_deadline_slack_seconds``.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["SLOTracker", "DEFAULT_WINDOWS", "DEFAULT_ALERT_PAIRS"]

#: default burn-rate windows (seconds): 5 min / 1 h / 6 h
DEFAULT_WINDOWS = (300.0, 3600.0, 21600.0)

#: SRE-workbook multiwindow multi-burn alert pairs:
#: (long_window_s, short_window_s, burn_threshold)
DEFAULT_ALERT_PAIRS = ((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))


class SLOTracker:
    """Sliding-window good/bad accounting for one SLO.

    Events land in fixed-resolution time buckets (default: fine enough
    for 60 buckets across the smallest window); windowed ratios read
    the ring, period totals are plain counters. O(1) per event, O(ring)
    per read — reads happen at dashboards' pace, not traffic's."""

    def __init__(self, name: str, objective: float,
                 windows: Sequence[float] = DEFAULT_WINDOWS,
                 period_s: float = 30 * 86400.0,
                 resolution_s: Optional[float] = None,
                 clock=time.monotonic):
        if not (0.0 < objective < 1.0):
            raise ValueError(f"SLO objective must be in (0, 1), got "
                             f"{objective} (it is a fraction, not a %)")
        if not windows:
            raise ValueError("SLOTracker needs >= 1 burn-rate window")
        self.name = name
        self.objective = float(objective)
        self.budget = 1.0 - float(objective)
        self.windows = tuple(sorted(float(w) for w in windows))
        if any(w <= 0 for w in self.windows):
            raise ValueError("burn-rate windows must be > 0 seconds")
        self.period_s = float(period_s)
        self.resolution_s = float(resolution_s) if resolution_s \
            else max(self.windows[0] / 60.0, 1.0)
        self.clock = clock
        # ring of [bucket_index, good, bad]; bounded by the largest
        # window (plus one bucket of slack for the partial edge)
        maxlen = int(math.ceil(self.windows[-1] / self.resolution_s)) + 1
        self._buckets: collections.deque = collections.deque(
            maxlen=maxlen)
        self.total_good = 0
        self.total_bad = 0

    # -- recording ----------------------------------------------------------
    def record(self, good: int = 0, bad: int = 0,
               t: Optional[float] = None) -> None:
        if good < 0 or bad < 0:
            raise ValueError("good/bad counts must be >= 0")
        if not (good or bad):
            return
        now = self.clock() if t is None else float(t)
        idx = int(now // self.resolution_s)
        if self._buckets and self._buckets[-1][0] == idx:
            b = self._buckets[-1]
            b[1] += good
            b[2] += bad
        else:
            if self._buckets and idx < self._buckets[-1][0]:
                # clock went backwards (test clocks, NTP): fold into the
                # newest bucket rather than corrupting ring order
                b = self._buckets[-1]
                b[1] += good
                b[2] += bad
            else:
                self._buckets.append([idx, good, bad])
        self.total_good += good
        self.total_bad += bad

    # -- reads --------------------------------------------------------------
    def _window_counts(self, window_s: float,
                       t: Optional[float] = None) -> Tuple[int, int]:
        now = self.clock() if t is None else float(t)
        lo = (now - float(window_s)) // self.resolution_s
        good = bad = 0
        for idx, g, b in self._buckets:
            if idx > lo:
                good += g
                bad += b
        return good, bad

    def error_ratio(self, window_s: float,
                    t: Optional[float] = None) -> float:
        """bad / (good + bad) over the window; 0.0 with no traffic (no
        traffic spends no budget)."""
        good, bad = self._window_counts(window_s, t)
        total = good + bad
        return bad / total if total else 0.0

    def burn_rate(self, window_s: float,
                  t: Optional[float] = None) -> float:
        """error_ratio / budget: 1.0 = spending exactly the budget."""
        return self.error_ratio(window_s, t) / self.budget

    def budget_remaining(self) -> float:
        """Fraction of the period's error budget left, from the period
        totals: 1.0 untouched, 0.0 exhausted, negative = blown."""
        total = self.total_good + self.total_bad
        if not total:
            return 1.0
        consumed = (self.total_bad / total) / self.budget
        return 1.0 - consumed

    def should_alert(self, pairs: Sequence[Tuple[float, float, float]]
                     = DEFAULT_ALERT_PAIRS,
                     t: Optional[float] = None) -> List[dict]:
        """Multiwindow multi-burn: a pair fires when BOTH its long and
        short windows burn above the threshold (long = significant,
        short = still happening). Returns the firing pairs (empty =
        healthy)."""
        out = []
        for long_w, short_w, thr in pairs:
            bl = self.burn_rate(long_w, t)
            bs = self.burn_rate(short_w, t)
            if bl >= thr and bs >= thr:
                out.append({"long_window_s": long_w,
                            "short_window_s": short_w,
                            "threshold": thr, "long_burn": bl,
                            "short_burn": bs})
        return out

    # -- export -------------------------------------------------------------
    def publish(self, registry=None, t: Optional[float] = None) -> None:
        """Export the burn gauges: ``slo_burn_rate{slo,window}`` per
        configured window, ``slo_error_budget_remaining{slo}`` and
        ``slo_objective{slo}``."""
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        g = registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate by SLO and window (1.0 = spending "
            "exactly the budget)")
        for w in self.windows:
            g.set(self.burn_rate(w, t), slo=self.name, window=f"{w:g}s")
        registry.gauge(
            "slo_error_budget_remaining",
            "fraction of the period error budget left (negative = "
            "blown)").set(self.budget_remaining(), slo=self.name)
        registry.gauge(
            "slo_objective", "configured SLO objective fraction").set(
            self.objective, slo=self.name)

    def snapshot(self) -> Dict[str, float]:
        d: Dict[str, float] = {
            "objective": self.objective,
            "budget_remaining": self.budget_remaining(),
            "total_good": float(self.total_good),
            "total_bad": float(self.total_bad)}
        for w in self.windows:
            d[f"burn_{w:g}s"] = self.burn_rate(w)
        return d
