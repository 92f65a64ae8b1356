"""Device memory accounting: per-kind measured peaks, a pre-flight check
and a live-buffer census, on PyTorch's CUDA caching allocator.

Port of ``paddle_tpu/monitor/memory.py``. The JAX module reads
``compiled.memory_analysis()`` and ``jax.live_arrays()``; here:

- a **program budget** (:class:`ProgramMemory`) for a kind of work
  (``step``, ``prefill``, ``decode``) is the measured peak of that
  kind's first run: ``torch.cuda.reset_peak_memory_stats()`` before it,
  ``max_memory_allocated()`` after. There is no compiled program, so
  ``analyze_compiled`` has no counterpart;
- the **pre-flight check** (:func:`preflight_check`,
  ``FLAGS_memory_preflight``) compares the bytes known before a run
  (parameters, gradients, optimizer slots, KV pools; :func:`known_bytes`)
  against the card's memory from ``torch.cuda.mem_get_info()``;
- the **live-buffer census** (:func:`live_buffer_census`) splits the
  allocator's ``memory_allocated()`` into a ``TrainStep``'s params,
  opt_state and buffers, and ``other``: everything else the allocator
  holds (activations, batches, gradients between steps, the workspace);
  :class:`LeakMonitor` flags step-over-step growth of the total.

On the CPU the allocator publishes nothing: stats read None, the census
counts the step's own tensors and ``other`` stays 0.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch

__all__ = [
    "ProgramMemory", "MemoryBudgetError", "measure_program",
    "record_program", "programs", "device_memory_stats", "device_hbm_bytes",
    "known_bytes", "preflight_check", "live_buffer_census", "live_bytes",
    "publish_census", "LeakMonitor", "memory_summary", "fmt_bytes",
]

CENSUS_CATEGORIES = ("params", "opt_state", "buffers", "other", "total")


def fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:,.1f} {unit}"
        n /= 1024
    return f"{n:,.1f} TiB"


class MemoryBudgetError(RuntimeError):
    """Pre-flight says the work will not fit the card; carries the
    numbers for programmatic handling."""

    def __init__(self, message: str, estimate_bytes: int = 0,
                 limit_bytes: int = 0):
        super().__init__(message)
        self.estimate_bytes = estimate_bytes
        self.limit_bytes = limit_bytes


@dataclass
class ProgramMemory:
    """The device-memory budget of one kind of work: the allocator's
    bytes in use when the kind's first run began (``argument_bytes``)
    and its measured peak during that run (``peak_bytes``)."""

    kind: str
    argument_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        """What the run allocated above what it started with."""
        return max(0, self.peak_bytes - self.argument_bytes)

    def as_dict(self) -> Dict[str, int]:
        return {"kind": self.kind, "argument_bytes": self.argument_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes}


class measure_program:
    """Context manager measuring one run of ``kind`` on ``device``:
    resets the peak, runs the body, and records the :class:`ProgramMemory`
    (:func:`record_program`). On the CPU it records nothing. Its
    ``result`` is the record, or None."""

    def __init__(self, kind: str, device=None):
        self.kind = kind
        self.device = torch.device(device) if device is not None else None
        self.result: Optional[ProgramMemory] = None

    def _cuda(self) -> bool:
        return (self.device is not None and self.device.type == "cuda"
                and torch.cuda.is_available())

    def __enter__(self):
        if self._cuda():
            torch.cuda.reset_peak_memory_stats(self.device)
            self._start = torch.cuda.memory_allocated(self.device)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None and self._cuda():
            self.result = ProgramMemory(
                self.kind, argument_bytes=int(self._start),
                peak_bytes=int(torch.cuda.max_memory_allocated(
                    self.device)))
            record_program(self.result)
        return False


# ---------------------------------------------------------------------------
# Process-global program table (memory_summary's and /statusz's source)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_PROGRAMS: Dict[str, ProgramMemory] = {}


def record_program(pm: ProgramMemory) -> None:
    """Register a kind's budget process-wide (newest per kind wins)."""
    with _LOCK:
        _PROGRAMS[pm.kind] = pm


def programs() -> Dict[str, ProgramMemory]:
    """Snapshot of the process-global per-kind budgets."""
    with _LOCK:
        return dict(_PROGRAMS)


# ---------------------------------------------------------------------------
# Device actuals
# ---------------------------------------------------------------------------

def _device(device=None) -> Optional[torch.device]:
    if device is not None:
        d = torch.device(device)
        return d if d.type == "cuda" else None
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else None


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's counters (``torch.cuda.memory_stats``)
    plus ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_free`` and
    ``bytes_limit`` (``mem_get_info``), or None without a card."""
    dev = _device(device)
    if dev is None:
        return None
    try:
        stats = {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
                 if isinstance(v, (int, float))}
        free, total = torch.cuda.mem_get_info(dev)
    except Exception:
        return None
    stats.update(bytes_in_use=int(torch.cuda.memory_allocated(dev)),
                 peak_bytes_in_use=int(torch.cuda.max_memory_allocated(dev)),
                 bytes_free=int(free), bytes_limit=int(total))
    return stats


def device_hbm_bytes(device=None) -> Optional[int]:
    """The card's total memory, or None without a card."""
    stats = device_memory_stats(device)
    return None if stats is None else stats["bytes_limit"]


def _nbytes(ts: Iterable) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def known_bytes(train_step=None, engine=None) -> int:
    """The bytes a run needs before its first step: a ``TrainStep``'s
    parameters, one gradient per trainable parameter and its optimizer's
    slots, or a serving engine's parameter copy and KV pools."""
    n = 0
    if train_step is not None:
        params = list(train_step.layer.parameters())
        n += _nbytes(params)
        n += _nbytes(p for p in params if p.requires_grad)
        n += _nbytes(_opt_tensors(train_step.optimizer))
    if engine is not None:
        n += _nbytes(engine.params.values()) + _nbytes(
            engine.buffers.values())
        c = engine.cache
        n += _nbytes((c.k, c.v, c.k_scale, c.v_scale))
    return n


def _preflight_limit(limit_bytes: Optional[int], device) -> Optional[int]:
    if limit_bytes is not None:
        return int(limit_bytes)
    from ..core.flags import get_flag
    mb = int(get_flag("memory_preflight_limit_mb") or 0)
    if mb > 0:
        return mb << 20
    dev = _device(device)
    if dev is None:
        return None
    _, total = torch.cuda.mem_get_info(dev)
    return int(total)


def preflight_check(program, limit_bytes: Optional[int] = None,
                    device=None, action: Optional[str] = None) \
        -> Optional[dict]:
    """OOM pre-flight: compare an estimate against the card's budget
    BEFORE the first step runs. ``program`` is a byte count (for example
    :func:`known_bytes`), a :class:`ProgramMemory` (its peak) or a dict
    of them (the largest).

    ``action`` defaults to ``FLAGS_memory_preflight`` ('' = off, 'warn',
    'raise'); the limit comes from ``limit_bytes``, else
    ``FLAGS_memory_preflight_limit_mb``, else the card's total memory
    (``mem_get_info``; the estimate's own tensors may already be
    allocated, so free memory would count them twice). Returns ``{'estimate_bytes', 'limit_bytes',
    'fits', 'kind'}``, or None when the check is off or no budget is
    known (the CPU without an explicit limit)."""
    from ..core.flags import get_flag
    act = action if action is not None else get_flag("memory_preflight")
    if not act:
        return None
    if act not in ("warn", "raise"):
        raise ValueError(f"memory_preflight: unknown action {act!r} "
                         "(expected '', 'warn' or 'raise')")
    limit = _preflight_limit(limit_bytes, device)
    if not limit:
        return None
    if isinstance(program, (int, float)):
        kind, est = "known", int(program)
    elif isinstance(program, ProgramMemory):
        kind, est = program.kind, program.peak_bytes
    else:
        if not program:
            return None
        kind, pm = max(dict(program).items(),
                       key=lambda kv: kv[1].peak_bytes)
        est = pm.peak_bytes
    result = {"estimate_bytes": est, "limit_bytes": int(limit),
              "fits": est <= limit, "kind": kind}
    if est <= limit:
        return result
    msg = (f"memory pre-flight: {kind!r} needs an estimated "
           f"{fmt_bytes(est)} of device memory but the budget is "
           f"{fmt_bytes(limit)} — this config is expected to OOM. Shrink "
           "the batch, or raise FLAGS_memory_preflight_limit_mb if the "
           "budget is wrong (docs/OBSERVABILITY.md).")
    try:
        from .metrics import get_registry
        get_registry().counter(
            "memory_preflight_failures_total",
            "programs whose static HBM estimate exceeded the budget"
        ).inc(kind=kind)
    except Exception:
        pass
    if act == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return result
    raise MemoryBudgetError(msg, estimate_bytes=est, limit_bytes=int(limit))


# ---------------------------------------------------------------------------
# Live-buffer census
# ---------------------------------------------------------------------------

def _opt_tensors(optimizer) -> List[torch.Tensor]:
    """The optimizer's slot tensors where they live (never copied)."""
    acc = getattr(optimizer, "_accumulators", None) or {}
    return [s for slots in acc.values() for s in slots]


def _unique(ts: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in ts:
        if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append(t)
    return out


def live_buffer_census(train_step=None, device=None) \
        -> Dict[str, Dict[str, int]]:
    """``{category: {'bytes', 'count'}}`` over ``params``, ``opt_state``,
    ``buffers`` (a ``TrainStep``'s own tensors, when one is given),
    ``other`` and ``total``. On the card ``total`` is the allocator's
    ``memory_allocated()`` and ``other`` is it minus the rest (count 0:
    the allocator does not count tensors); on the CPU ``total`` is the
    step's tensors and ``other`` 0."""
    cats = {c: {"bytes": 0, "count": 0} for c in CENSUS_CATEGORIES}
    owned = 0
    if train_step is not None:
        layer = train_step.layer
        groups = {"params": _unique(layer.parameters()),
                  "opt_state": _unique(_opt_tensors(train_step.optimizer)),
                  "buffers": _unique(layer.buffers())}
        for cat, ts in groups.items():
            cats[cat] = {"bytes": _nbytes(ts), "count": len(ts)}
            owned += cats[cat]["bytes"]
        if device is None:
            device = getattr(train_step, "device", None)
    dev = _device(device)
    if dev is not None:
        total = int(torch.cuda.memory_allocated(dev))
        cats["other"] = {"bytes": max(0, total - owned), "count": 0}
        cats["total"] = {"bytes": total, "count": sum(
            c["count"] for k, c in cats.items() if k != "total")}
    else:
        cats["total"] = {"bytes": owned, "count": sum(
            c["count"] for k, c in cats.items() if k != "total")}
    return cats


def live_bytes(device=None) -> int:
    """The allocator's bytes in use on the card (0 without one)."""
    dev = _device(device)
    return int(torch.cuda.memory_allocated(dev)) if dev is not None else 0


def publish_census(train_step=None, registry=None) \
        -> Dict[str, Dict[str, int]]:
    """Run a census and publish ``live_buffer_bytes`` /
    ``live_buffer_count`` gauges labelled by category. Returns it."""
    census = live_buffer_census(train_step)
    from .metrics import get_registry
    reg = registry if registry is not None else get_registry()
    for cat, c in census.items():
        reg.gauge("live_buffer_bytes",
                  "live device bytes by attribution category "
                  "(monitor.memory census)").set(c["bytes"], category=cat)
        reg.gauge("live_buffer_count",
                  "live tensors by attribution category"
                  ).set(c["count"], category=cat)
    return census


class LeakMonitor:
    """Flags monotonic step-over-step growth of live device bytes::

        leak = LeakMonitor(window=4, tolerance_bytes=1 << 20)
        for step, batch in enumerate(loader):
            train_step(*batch)
            if leak.observe():          # reads live_bytes() by default
                ...                     # warned + counted already

    A leak is suspected when the last ``window`` observations grew
    STRICTLY at every step and the total growth over the window exceeds
    ``tolerance_bytes`` (a steady training loop holds its bytes flat).
    Suspicion warns (RuntimeWarning), bumps
    ``memory_leak_suspected_total`` and counts in :attr:`suspected`."""

    def __init__(self, window: int = 4, tolerance_bytes: int = 1 << 20,
                 registry=None):
        if window < 2:
            raise ValueError("LeakMonitor: window must be >= 2")
        self.window = int(window)
        self.tolerance_bytes = int(tolerance_bytes)
        self._registry = registry
        self._history: List[int] = []
        self.suspected = 0

    def observe(self, total_bytes: Optional[int] = None,
                step: Optional[int] = None) -> bool:
        """Record one sample (default: :func:`live_bytes` now); True when
        this sample completes a suspicious growth window."""
        v = int(live_bytes() if total_bytes is None else total_bytes)
        self._history.append(v)
        if len(self._history) > self.window + 1:
            del self._history[:-(self.window + 1)]
        h = self._history
        if len(h) < self.window + 1:
            return False
        grew = all(b > a for a, b in zip(h, h[1:]))
        if not grew or h[-1] - h[0] <= self.tolerance_bytes:
            return False
        self.suspected += 1
        growth = h[-1] - h[0]
        at = f" at step {step}" if step is not None else ""
        warnings.warn(
            f"live-buffer leak suspected{at}: live bytes grew "
            f"{fmt_bytes(growth)} over the last {self.window} "
            f"observations ({fmt_bytes(h[0])} -> {fmt_bytes(h[-1])}); "
            "a steady training loop should hold its bytes flat — look "
            "for tensors retained across steps (loss history kept on "
            "the card, growing lists of activations)",
            RuntimeWarning, stacklevel=2)
        try:
            from .metrics import get_registry
            reg = self._registry if self._registry is not None \
                else get_registry()
            reg.counter("memory_leak_suspected_total",
                        "LeakMonitor growth-window trips").inc()
        except Exception:
            pass
        return True


def memory_summary(train_step=None, device=None) -> str:
    """Human-readable report in the spirit of
    ``paddle.device.cuda.memory_summary``: the allocator's actuals, the
    measured per-kind budgets and the live-buffer census."""
    lines = ["=== paddle_tpu_torch memory summary ==="]
    dev = _device(device if device is not None else
                  getattr(train_step, "device", None))
    if dev is not None:
        lines.append(f"device: {torch.cuda.get_device_name(dev)} ({dev})")
    stats = device_memory_stats(dev) if dev is not None else None
    if stats is None:
        lines.append("allocator stats: n/a (no card)")
    else:
        lines.append(
            "allocator: in use " + fmt_bytes(stats["bytes_in_use"])
            + ", peak " + fmt_bytes(stats["peak_bytes_in_use"])
            + ", reserved " + fmt_bytes(stats.get(
                "reserved_bytes.all.current"))
            + ", free " + fmt_bytes(stats["bytes_free"])
            + " of " + fmt_bytes(stats["bytes_limit"]))
    progs = programs()
    if progs:
        lines.append("")
        lines.append("measured budgets (first run of each kind):")
        lines.append(f"  {'kind':<10} {'at start':>12} {'above':>12} "
                     f"{'peak':>12}")
        for kind in sorted(progs):
            pm = progs[kind]
            lines.append(f"  {kind:<10} {fmt_bytes(pm.argument_bytes):>12} "
                         f"{fmt_bytes(pm.temp_bytes):>12} "
                         f"{fmt_bytes(pm.peak_bytes):>12}")
    census = live_buffer_census(train_step, dev)
    lines.append("")
    lines.append("live buffers (allocator census):")
    for cat in CENSUS_CATEGORIES:
        c = census[cat]
        lines.append(f"  {cat:<14} {fmt_bytes(c['bytes']):>12} "
                     f"in {c['count']} tensor(s)")
    return "\n".join(lines) + "\n"
