"""Serving resilience primitives: typed overload, drain and watchdog
errors, the queue-delay overload detector, the SIGTERM drain latch and
atomic drain snapshots.

Counterpart of ``paddle_tpu/serving/resilience.py``. Overload,
cancellation and shutdown are states of the engine, not crashes: a shed
request is an answer ("come back later"), a drain is a planned handoff,
a hung dispatch is a structured incident.

- :class:`ServerOverloaded`: the typed admission refusal (reason
  ``queue_full``, ``overload`` or ``draining``);
- :class:`OverloadDetector`: an EWMA of head-of-queue delay with
  enter/exit hysteresis; while it is tripped the engine sheds every new
  submit;
- :class:`DrainLatch`: the signal handler only records the signal, the
  engine honours it at the next iteration boundary;
- :func:`save_drain_snapshot` / :func:`load_drain_snapshot`: undone
  work (queued and in-flight request specs) committed through the
  checkpoint protocol (``distributed.checkpoint._commit``), so a torn
  write (chaos site ``ckpt.write.torn``) never passes for a snapshot
  and a restarted engine falls back to the newest valid one. The
  snapshot's JSON document is the JAX package's, so a snapshot written
  by either package loads in the other;
- :class:`DecodeWatchdogError` and :class:`DispatchWorker`: a dispatch
  that outlives ``FLAGS_serve_watchdog_s`` raises instead of stalling
  the serving loop.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import shutil
import signal as signal_mod
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["ServerOverloaded", "EngineDrained", "DecodeWatchdogError",
           "DispatchWorker", "OverloadDetector", "DrainLatch",
           "DrainReport", "request_spec", "save_drain_snapshot",
           "load_drain_snapshot", "requests_from_snapshot",
           "DRAIN_STATE_NAME"]

#: the one payload file of a drain snapshot directory (next to the
#: checkpoint manifest that commits it)
DRAIN_STATE_NAME = "drain_state.json"

_DRAIN_DIR_RE = re.compile(r"^drain_(\d+)$")


class ServerOverloaded(RuntimeError):
    """Admission refused: the engine is shedding load.

    ``reason`` is ``queue_full`` (the bounded queue is full and the
    policy produced no victim), ``overload`` (the queue-delay detector is
    tripped) or ``draining`` (the engine is shutting down). The request
    was never admitted; a client backs off and retries."""

    def __init__(self, reason: str, queue_depth: Optional[int] = None,
                 ewma_s: Optional[float] = None,
                 threshold_s: Optional[float] = None):
        detail = {"queue_full": "request queue at capacity",
                  "overload": "queue-delay overload detector tripped",
                  "draining": "engine is draining"}.get(reason, reason)
        msg = f"server overloaded ({reason}): {detail}"
        if queue_depth is not None:
            msg += f"; queue_depth={queue_depth}"
        if ewma_s is not None:
            msg += f"; queue_delay_ewma={ewma_s:.3f}s"
        if threshold_s is not None:
            msg += f" (threshold {threshold_s:g}s)"
        super().__init__(msg)
        self.reason = reason
        self.queue_depth = queue_depth
        self.ewma_s = ewma_s
        self.threshold_s = threshold_s


class EngineDrained(Exception):
    """Raised by ``ServingEngine.step`` / ``run`` after a latched drain
    signal was honoured: in-flight work finished or was snapshotted,
    nothing was lost. Carries the :class:`DrainReport`."""

    def __init__(self, report: "DrainReport"):
        super().__init__(
            f"engine drained: {report.completed} completed in the grace "
            f"period, {report.snapshotted} snapshotted"
            + (f" to {report.path}" if report.path else ""))
        self.report = report


class DecodeWatchdogError(RuntimeError):
    """A serving dispatch exceeded ``FLAGS_serve_watchdog_s``.

    PyTorch cannot cancel launched work from Python, so the dispatch
    thread is abandoned and the caller gets this error (and a flight
    dump when recording is on). ``retry_safe`` is True when the
    abandoned dispatch had launched nothing and never will (it stops at
    its first launch once abandoned): the pools and the sampling
    generator are as they were, so retrying the step is token-exact for
    greedy requests. False when it had started launching: it may still
    be writing the pools in place."""

    def __init__(self, kind: str, timeout_s: float, dispatch_seq: int,
                 active_slots: int, retry_safe: bool = True):
        tail = (
            "retrying the step is token-exact for greedy requests "
            "(nothing was launched: same positions, same K/V writes)."
            if retry_safe else
            "the dispatch had started launching and may still be "
            "writing the KV pools in place, so the step CANNOT be "
            "retried: restart the engine.")
        super().__init__(
            f"serving {kind} dispatch #{dispatch_seq} did not return "
            f"within {timeout_s:g}s (FLAGS_serve_watchdog_s) with "
            f"{active_slots} active slot(s). The dispatch thread is "
            f"abandoned; {tail}")
        self.kind = kind
        self.timeout_s = timeout_s
        self.dispatch_seq = dispatch_seq
        self.active_slots = active_slots
        self.retry_safe = retry_safe


class DispatchWorker:
    """One long-lived thread serving every watchdog-guarded dispatch.

    Created once and fed jobs over a queue, so an armed watchdog costs a
    queue handoff and an event wait a dispatch, not a thread. Only a
    trip costs a thread: the worker is stuck inside the hung job, so the
    engine abandons it and the next dispatch starts a fresh one (the
    abandoned thread exits by itself once the job returns)."""

    def __init__(self):
        self._work: "queue.Queue" = queue.Queue()
        self._abandoned = False
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-watchdog-worker")
        self.thread.start()

    @property
    def usable(self) -> bool:
        return not self._abandoned and self.thread.is_alive()

    def _loop(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            fn, result, done = item
            try:
                result["value"] = fn()
            except BaseException as e:  # surfaces on the caller's thread
                result["error"] = e
            finally:
                done.set()
            if self._abandoned:
                return

    def dispatch(self, fn, timeout_s: float) -> Optional[dict]:
        """Run ``fn`` on the worker thread; None = timed out (the worker
        is abandoned and must not be reused)."""
        result: dict = {}
        done = threading.Event()
        self._work.put((fn, result, done))
        if not done.wait(timeout_s):
            self._abandoned = True
            return None
        return result

    def close(self) -> None:
        """Stop an idle worker (an abandoned one exits by itself)."""
        self._abandoned = True
        self._work.put(None)


@dataclass
class DrainReport:
    """What a drain did: requests finished inside the grace budget,
    requests snapshotted for a successor engine, and the committed
    snapshot path (None when nothing was pending)."""

    completed: int
    snapshotted: int
    path: Optional[str]


class OverloadDetector:
    """EWMA of head-of-queue delay with enter/exit hysteresis.

    Observed once per engine iteration with the age of the oldest
    waiting request (0 when the queue is empty), which keeps rising while
    the queue is stuck. Trips at ``threshold_s``; recovers at
    ``threshold_s * exit_frac``, so the state does not flap."""

    def __init__(self, threshold_s: float, alpha: float = 0.3,
                 exit_frac: float = 0.5):
        if threshold_s <= 0:
            raise ValueError("overload threshold must be > 0")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("EWMA alpha must be in (0, 1]")
        if not (0.0 < exit_frac < 1.0):
            # exit_frac >= 1 inverts the hysteresis
            raise ValueError("overload exit_frac must be in (0, 1)")
        self.threshold_s = float(threshold_s)
        self.alpha = float(alpha)
        self.exit_s = float(threshold_s) * float(exit_frac)
        self.ewma_s = 0.0
        self.overloaded = False

    def observe(self, queue_delay_s: float) -> Optional[str]:
        """Fold one head-of-queue delay sample in; returns ``"enter"`` /
        ``"exit"`` on a state transition, else None."""
        self.ewma_s = (self.alpha * float(queue_delay_s)
                       + (1.0 - self.alpha) * self.ewma_s)
        if not self.overloaded and self.ewma_s > self.threshold_s:
            self.overloaded = True
            return "enter"
        if self.overloaded and self.ewma_s < self.exit_s:
            self.overloaded = False
            return "exit"
        return None


class DrainLatch:
    """Latch a shutdown signal; the engine honours it at the next
    iteration boundary. ``trigger()`` arms it programmatically.
    ``close()`` restores the original handlers. Only the main thread may
    install handlers: elsewhere the latch works by ``trigger()`` alone."""

    def __init__(self, signals=(signal_mod.SIGTERM,)):
        self._signum: Optional[int] = None
        self._old: Dict[int, object] = {}
        for sig in signals or ():
            try:
                self._old[sig] = signal_mod.signal(sig, self._on_signal)
            except (ValueError, OSError):
                logger.warning("DrainLatch: cannot install handler for "
                               "signal %s", sig)

    def _on_signal(self, signum, frame):
        self._signum = signum

    @property
    def triggered(self) -> bool:
        return self._signum is not None

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def trigger(self) -> None:
        self._signum = -1

    def close(self) -> None:
        for sig, old in self._old.items():
            try:
                signal_mod.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old = {}


# ---------------------------------------------------------------------------
# drain snapshots
# ---------------------------------------------------------------------------


def request_spec(st) -> dict:
    """Serializable spec of a request's undone work: the original
    ``prompt`` and the tokens ``generated`` before the drain, so a
    successor continues the stream (greedy continuation is token-exact,
    the recompute-preemption property). Callbacks do not serialize."""
    req = st.request
    s = req.sampling
    spec = {
        "request_id": int(req.request_id),
        "prompt": [int(t) for t in req.prompt.tolist()],
        "generated": [int(t) for t in st.generated],
        "max_new_tokens": int(req.max_new_tokens),
        "sampling": {"temperature": float(s.temperature),
                     "top_k": int(s.top_k), "top_p": float(s.top_p)},
        "eos_token_id": (None if req.eos_token_id is None
                         else int(req.eos_token_id)),
        "priority": int(req.priority),
        # chunked-prefill progress and uncommitted draft tokens: the
        # successor recomputes from prompt + generated either way
        "prefill_pos": int(st.prefill_pos),
        "draft": [int(t) for t in st.draft],
    }
    # the successor resumes the same trace identity
    trace_id = (st.trace.trace_id if st.trace is not None
                else req.trace_id)
    if trace_id is not None:
        spec["trace_id"] = str(trace_id)
    for k in ("trace_parent", "trace_process"):
        v = getattr(req, k)
        if v is not None:
            spec[k] = str(v)
    return spec


def save_drain_snapshot(root: str, specs: List[dict]) -> str:
    """Commit ``specs`` as ``<root>/drain_<n>`` through the checkpoint
    protocol: stage, fsync'd manifest, rename."""
    from ..distributed.checkpoint import STAGING_SUFFIX, _commit
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    n = max((_drain_seq(name) for name in os.listdir(root)), default=0) + 1
    final = os.path.join(root, f"drain_{n}")
    tmp = final + STAGING_SUFFIX
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    doc = {"format": 1, "created": time.time(),
           "requests": list(specs)}
    _commit(tmp, final, leaves={},
            extra_files={DRAIN_STATE_NAME: json.dumps(doc, indent=1)},
            step=n)
    return final


def _drain_seq(name: str) -> int:
    m = _DRAIN_DIR_RE.match(name)
    return int(m.group(1)) if m else 0


def load_drain_snapshot(root: str) \
        -> Tuple[Optional[str], List[dict]]:
    """Newest valid drain snapshot under ``root`` -> ``(path, specs)``,
    or ``(None, [])``. Torn or uncommitted snapshot directories are
    skipped with a ``checkpoint_fallback`` flight event."""
    from ..distributed.checkpoint import verify_checkpoint
    from ..monitor.flight_recorder import safe_record_event
    if not os.path.isdir(root):
        return None, []
    seqs = sorted((_drain_seq(name) for name in os.listdir(root)
                   if _DRAIN_DIR_RE.match(name)), reverse=True)
    for n in seqs:
        path = os.path.join(root, f"drain_{n}")
        reason = verify_checkpoint(path)
        if reason is None:
            try:
                with open(os.path.join(path, DRAIN_STATE_NAME)) as f:
                    doc = json.load(f)
                return path, list(doc.get("requests") or [])
            except (OSError, ValueError) as e:
                reason = f"drain state unreadable: {e!r}"
        logger.warning("drain restore: skipping %s: %s", path, reason)
        safe_record_event("checkpoint_fallback", step=n, reason=reason,
                          kind="drain_snapshot")
    return None, []


def requests_from_snapshot(specs: List[dict]) -> List[object]:
    """Submittable :class:`~.scheduler.Request` objects from snapshot
    specs: the effective prompt (original + generated so far) with the
    remaining token budget, so a greedy request continues its stream
    token-exactly."""
    from .sampling import SamplingParams
    from .scheduler import Request
    out = []
    for d in specs:
        generated = list(d.get("generated") or [])
        remaining = int(d["max_new_tokens"]) - len(generated)
        if remaining < 1:
            continue                    # nothing left undone
        out.append(Request(
            list(d["prompt"]) + generated,
            max_new_tokens=remaining,
            sampling=SamplingParams(**(d.get("sampling") or {})),
            eos_token_id=d.get("eos_token_id"),
            priority=int(d.get("priority", 0)),
            trace_id=d.get("trace_id"),
            trace_parent=d.get("trace_parent"),
            trace_process=d.get("trace_process")))
    return out
