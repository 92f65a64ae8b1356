"""Crash flight recorder: a bounded ring of recent step records, dumped
to JSON when a run dies.

Production training crashes at step 40k tell you nothing unless the
process wrote down what it was doing: this module keeps the last N step
records (step index, loss, wall/dispatch ms), a
bounded event log (recompiles, eager collectives, watchdog trips), and
an environment fingerprint (torch and CUDA versions, the card's name,
count and power limit, git sha, active flags) in host memory — O(1) per step, no device sync — and
serializes the whole thing to ``flight_recorder_<pid>.json`` on:

- an **unhandled exception** (``install()`` chains ``sys.excepthook``);
- a **NaN-watchdog trip** (``TrainStep(check_numerics=...)`` calls
  :func:`trip_dump` before raising/warning);
- an explicit :meth:`FlightRecorder.dump` call.

Hard crashes (SIGSEGV, deadlock SIGABRT) can't run python code, so
``install()`` also wires :mod:`faulthandler` to a sidecar
``flight_recorder_<pid>.traceback`` file.

Recording is populated by ``TrainStep`` when ``FLAGS_monitor`` or
``FLAGS_flight_recorder`` is on (both off = zero recorder writes on the
hot path, same contract as the metrics registry). Render a dump with
``python tools/monitor_report.py --flight flight_recorder_<pid>.json``.

The fault-tolerance stack (docs/FAULT_TOLERANCE.md) records its
*recovery events* here so a post-mortem reads as one timeline: the
event names in :data:`RECOVERY_EVENTS` — ``checkpoint_commit`` (a
checkpoint became durable+visible), ``checkpoint_fallback`` (an
invalid/torn checkpoint was skipped at resume), ``collective_timeout``
(the eager-collective watchdog tripped), ``nonfinite_skip`` (an update
was rolled back under ``skip_nonfinite_budget``), ``preempted``
(SIGTERM honoured with a final commit), ``chaos`` (an injected fault
fired) — are rendered as a dedicated "Recovery timeline" section by
``monitor_report.py --flight``.

Port of ``paddle_tpu/monitor/flight_recorder.py``: the ring, the events,
:func:`trip_dump` and the ``excepthook``/``faulthandler`` install are a
copy; the fingerprint reads torch and the card instead of JAX.
"""

from __future__ import annotations

import collections
import json
import math
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder",
           "enabled", "safe_record_event", "trip_dump", "load_dump",
           "RECOVERY_EVENTS", "register_dump_provider"]

_EVENT_CAPACITY = 128

# event names that make up a run's recovery timeline (emitters:
# distributed/checkpoint, distributed/collective, jit/to_static,
# testing/chaos, serving/engine); monitor_report.py --flight renders
# these separately
RECOVERY_EVENTS = ("checkpoint_commit", "checkpoint_fallback",
                   "collective_timeout", "nonfinite_skip", "preempted",
                   "trip", "chaos", "request_failed", "request_expired",
                   "request_cancelled", "request_drained", "request_shed",
                   "decode_watchdog", "overload", "drained",
                   "replica_migration", "health_spike")


# dump-time attachment hooks: other forensic subsystems (the structured
# tracer) register a provider so every dump — crash, watchdog trip,
# explicit — carries their in-flight state under the given key. Called
# only at dump time (never on the hot path) and best-effort: a raising
# provider is skipped, the dump must still land.
_DUMP_PROVIDERS: Dict[str, Any] = {}


def register_dump_provider(key: str, fn) -> None:
    """Attach ``fn()``'s return value under ``doc[key]`` in every
    future dump. Re-registering a key replaces the provider."""
    _DUMP_PROVIDERS[key] = fn


def _json_safe(v: Any) -> Any:
    """One scalar → something json.dumps(allow_nan=False) accepts.
    Device scalars are read back HERE (dump time), never on the hot
    path; non-finite floats become strings ('nan' is the whole point of
    some dumps)."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    try:
        f = float(v)
    except Exception:
        return repr(v)
    if math.isfinite(f):
        return f
    return repr(f)


def _json_safe_tree(v: Any) -> Any:
    """Recursive :func:`_json_safe` over dicts/lists — provider output
    is arbitrary nested structure."""
    if isinstance(v, dict):
        return {str(k): _json_safe_tree(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe_tree(x) for x in v]
    return _json_safe(v)


class FlightRecorder:
    """Bounded in-memory black box for one training process."""

    def __init__(self, capacity: Optional[int] = None,
                 dump_dir: Optional[str] = None):
        if capacity is None:
            try:
                from ..core.flags import get_flag
                capacity = int(get_flag("flight_recorder_capacity"))
            except Exception:
                capacity = 256
        self.capacity = max(1, int(capacity))
        self._dump_dir = dump_dir
        self._lock = threading.Lock()
        self._steps: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._events: collections.deque = collections.deque(
            maxlen=_EVENT_CAPACITY)
        self._fingerprint: Optional[Dict[str, Any]] = None
        self._installed = False
        self._prev_excepthook = None
        self._faulthandler_file = None
        self.record_count = 0          # mutation probe (tests pin the
        self.dump_count = 0            # monitor-off hot path writes none)

    # -- recording (hot path: dict build + deque append, no sync) ----------
    def record_step(self, step: int, loss: Any = None,
                    wall_ms: Optional[float] = None,
                    dispatch_ms: Optional[float] = None,
                    kind: str = "step", **extra) -> None:
        """O(1): ``loss`` may be a DEVICE scalar — it is held by
        reference and only read back at dump time."""
        rec = {"step": int(step), "kind": kind, "loss": loss,
               "wall_ms": wall_ms, "dispatch_ms": dispatch_ms,
               "ts": time.time()}
        if extra:
            rec.update(extra)
        with self._lock:
            self._steps.append(rec)
            self.record_count += 1

    def record_event(self, event: str, **fields) -> None:
        """Recompiles, collective dispatches, watchdog trips — anything
        sparse enough to want exact records instead of counters."""
        rec = {"event": event, "ts": time.time()}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)
            self.record_count += 1

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()
            self._events.clear()

    @property
    def steps(self) -> List[dict]:
        with self._lock:
            return list(self._steps)

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    # -- fingerprint -------------------------------------------------------
    def fingerprint(self) -> Dict[str, Any]:
        """Environment identity, computed once: enough to answer 'what
        exactly was this run' from the dump alone."""
        if self._fingerprint is not None:
            return self._fingerprint
        fp: Dict[str, Any] = {"pid": os.getpid(),
                              "argv": list(sys.argv),
                              "python": sys.version.split()[0]}
        try:
            import torch
            fp["torch_version"] = torch.__version__
            fp["cuda_version"] = torch.version.cuda
            cuda = torch.cuda.is_available()
            fp["backend"] = "cuda" if cuda else "cpu"
            fp["device_kind"] = (torch.cuda.get_device_name(0) if cuda
                                 else "cpu")
            fp["device_count"] = torch.cuda.device_count() if cuda else 0
        except Exception:
            pass
        fp["power_limit"] = self._power_limit()
        fp["git_sha"] = self._git_sha()
        self._fingerprint = fp
        return fp

    @staticmethod
    def _power_limit() -> Optional[str]:
        """The first card's power limit as ``nvidia-smi`` reports it,
        where ``nvidia-smi`` is on the PATH (a card set below its
        maximum runs slower under load)."""
        import shutil
        import subprocess
        smi = shutil.which("nvidia-smi")
        if smi is None:
            return None
        try:
            out = subprocess.run(
                [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=10)
            lines = out.stdout.strip().splitlines()
            return lines[0].strip() if lines else None
        except Exception:
            return None

    @staticmethod
    def _git_sha() -> Optional[str]:
        import subprocess
        try:
            root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            out = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], cwd=root,
                capture_output=True, text=True, timeout=5)
            sha = out.stdout.strip()
            return sha or None
        except Exception:
            return None

    def _flags_snapshot(self) -> Dict[str, Any]:
        try:
            from ..core import flags as F
            return {name: _json_safe(F.get_flag(name))
                    for name in sorted(F._REGISTRY)}
        except Exception:
            return {}

    # -- dumping -----------------------------------------------------------
    def default_path(self, suffix: str = ".json") -> str:
        d = self._dump_dir
        if not d:
            try:
                from ..core.flags import get_flag
                d = get_flag("flight_recorder_dir")
            except Exception:
                d = ""
        d = d or "."
        return os.path.join(d, f"flight_recorder_{os.getpid()}{suffix}")

    def doc(self, reason: str = "explicit",
            trip_step: Optional[int] = None,
            extra: Optional[dict] = None) -> dict:
        """The dump document as a JSON-safe dict — exactly what
        :meth:`dump` writes. Factored out so the admin server's
        ``/debug/flight`` serves the SAME payload a crash would leave
        on disk, without touching the filesystem."""
        with self._lock:
            steps = [dict(r) for r in self._steps]
            events = [dict(r) for r in self._events]
        for r in steps + events:
            for k, v in r.items():
                r[k] = _json_safe(v)
        doc = {"reason": reason,
               "trip_step": trip_step,
               "dumped_at": time.time(),
               "fingerprint": self.fingerprint(),
               "flags": self._flags_snapshot(),
               "capacity": self.capacity,
               "steps": steps,
               "events": events}
        if extra:
            doc.update({k: _json_safe(v) for k, v in extra.items()})
        for key, provider in list(_DUMP_PROVIDERS.items()):
            try:
                # deep-sanitize: one non-finite float anywhere in a
                # provider's tree must not sink the whole crash dump
                # at json.dump(allow_nan=False) time
                doc.setdefault(key, _json_safe_tree(provider()))
            except Exception:
                pass               # the dump itself must still land
        return doc

    def dump(self, path: Optional[str] = None, reason: str = "explicit",
             trip_step: Optional[int] = None,
             extra: Optional[dict] = None) -> str:
        """Serialize fingerprint + flags + ring contents to ``path``
        (default ``flight_recorder_<pid>.json`` in
        ``FLAGS_flight_recorder_dir`` or cwd). Overwrites: the newest
        state of THIS process is the record of interest. Returns the
        path written."""
        path = path or self.default_path()
        doc = self.doc(reason=reason, trip_step=trip_step, extra=extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, allow_nan=False)
        os.replace(tmp, path)          # atomic: a crash mid-dump never
        self.dump_count += 1           # leaves a truncated record
        return path

    # -- crash wiring ------------------------------------------------------
    def install(self, excepthook: bool = True,
                enable_faulthandler: bool = True) -> None:
        """Idempotent: chain ``sys.excepthook`` to dump on unhandled
        exceptions, and point :mod:`faulthandler` at a sidecar file for
        crashes python never sees."""
        if self._installed:
            return
        self._installed = True
        if excepthook:
            self._prev_excepthook = sys.excepthook

            def hook(exc_type, exc, tb):
                try:
                    self.dump(reason="unhandled_exception",
                              extra={"exception":
                                     f"{exc_type.__name__}: {exc}"})
                except Exception:
                    pass               # the original traceback must win
                (self._prev_excepthook or sys.__excepthook__)(
                    exc_type, exc, tb)

            sys.excepthook = hook
        if enable_faulthandler:
            import faulthandler
            try:
                # remember whether someone else (pytest, the user) had
                # faulthandler on: uninstall() must give it back
                self._faulthandler_was_enabled = faulthandler.is_enabled()
                self._faulthandler_file = open(
                    self.default_path(suffix=".traceback"), "w")
                faulthandler.enable(file=self._faulthandler_file)
            except Exception:
                self._faulthandler_file = None

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._faulthandler_file is not None:
            import faulthandler
            try:
                if getattr(self, "_faulthandler_was_enabled", False):
                    faulthandler.enable()      # back to stderr, as before
                else:
                    faulthandler.disable()
                self._faulthandler_file.close()
            except Exception:
                pass
            self._faulthandler_file = None


# ---------------------------------------------------------------------------
# Process-global recorder
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_rec_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-global recorder (created on first use)."""
    global _recorder
    with _rec_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def set_flight_recorder(recorder: Optional[FlightRecorder]) \
        -> Optional[FlightRecorder]:
    """Swap the process-global recorder (tests); returns the old one."""
    global _recorder
    with _rec_lock:
        old, _recorder = _recorder, recorder
        return old


def enabled() -> bool:
    """True when TrainStep should record steps: ``FLAGS_monitor`` or
    ``FLAGS_flight_recorder``."""
    from ..core.flags import get_flag
    return bool(get_flag("monitor")) or bool(get_flag("flight_recorder"))


def safe_record_event(event: str, **fields) -> None:
    """Best-effort flight event: no-op unless recording is enabled
    (same gate as TrainStep records), and never raises — forensics must
    not take the emitting loop down. The one helper behind every
    guarded ``record_event`` call site (checkpoint fallbacks, serving
    lifecycle, collective timeouts)."""
    try:
        if not enabled():
            return
        get_flight_recorder().record_event(event, **fields)
    except Exception:
        pass


def trip_dump(step: Optional[int] = None, reason: str = "nan_watchdog",
              **info) -> Optional[str]:
    """Dump the global recorder on a watchdog trip (best-effort: a
    forensics write must never mask the error being raised). Returns
    the dump path, or None when the dump itself failed."""
    try:
        fr = get_flight_recorder()
        fr.record_event("trip", reason=reason, step=step, **info)
        return fr.dump(reason=reason, trip_step=step, extra=info)
    except Exception:
        return None


def load_dump(path: str) -> dict:
    """Parse a flight-recorder dump file."""
    with open(path) as f:
        return json.load(f)
