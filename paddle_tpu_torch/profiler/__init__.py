"""Profiler: host ``RecordEvent`` timeline plus ``torch.profiler`` on the
card.

Port of ``paddle_tpu/profiler/__init__.py`` (reference:
paddle/fluid/platform/profiler.h RecordEvent + device_tracer.cc's CUPTI
timeline + fluid/profiler.py). The JAX module wraps ``jax.profiler``;
here :func:`start_profiler` / :func:`stop_profiler` run one
``torch.profiler.profile`` session with the CPU and (where a card is
present) CUDA activities, so a window's chrome trace names every kernel
the card ran, the hand-written ones of ``ops.kernels`` included (CUPTI
sees a launch through ``ctypes`` like any other). :class:`RecordEvent`
feeds the host timeline and opens a ``torch.profiler.record_function``
range, so a step appears on both.

Not ported: the JAX package's per-op hook on its ``Tensor`` facade
(``core.tensor.set_op_profile_hook``): the port has no facade, and
``torch.profiler`` records every operator itself.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Optional

import torch

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "profiler", "start_profiler", "stop_profiler",
           "summary", "profile_train_step", "export_chrome_tracing",
           "export_tensorboard", "chrome_trace_doc"]

_events = defaultdict(lambda: [0, 0.0])  # name -> [count, total_sec]
_active = [False]
# host timeline: (name, t_start_us, dur_us, thread_id); bounded so a long
# run cannot grow without limit (the chrome trace keeps the newest events)
_TIMELINE_CAP = 200_000
_timeline = []
# the running torch.profiler session and the directory its trace goes
# to, and the last finished session's chrome trace events (what a window
# exports)
_session = [None, None]
_device_events = []


def _timeline_add(name: str, t0: float, t1: float):
    if len(_timeline) >= _TIMELINE_CAP:
        del _timeline[: _TIMELINE_CAP // 2]
    _timeline.append((name, t0 * 1e6, (t1 - t0) * 1e6,
                      threading.get_ident()))


class RecordEvent:
    """Host-side RAII event marker (platform/profiler.h RecordEvent
    analogue); also a ``torch.profiler.record_function`` range, so the
    event appears in a profiler session's trace."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        try:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        except Exception:
            self._rf = None
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if _active[0]:
            t1 = time.perf_counter()
            rec = _events[self.name]
            rec[0] += 1
            rec[1] += t1 - self.t0
            _timeline_add(self.name, self.t0, t1)
        return False


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_profiler(state="All", tracer_option="Default", log_dir=None):
    """Begin host-event aggregation and a ``torch.profiler`` session
    (CPU and CUDA activities). With ``log_dir`` the session's chrome
    trace is also written there when it stops.

    Workflow::

        profiler.start_profiler(log_dir="/tmp/trace")
        ... train steps ...
        profiler.stop_profiler()
        print(profiler.summary())           # host events
    """
    _active[0] = True
    _events.clear()
    _timeline.clear()
    _device_events.clear()
    sess = torch.profiler.profile(activities=_activities())
    sess.__enter__()
    _session[:] = [sess, log_dir]


def _session_events(sess) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        sess.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in doc.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X"]


def stop_profiler(sorted_key=None, profile_path=None):
    """End aggregation and the session; its trace events are kept for
    :func:`chrome_trace_doc`. With ``profile_path`` the summary table
    (sorted by ``sorted_key``: 'calls'/'total'/'avg', default total) is
    written there (fluid.profiler.stop_profiler parity)."""
    _active[0] = False
    sess, log_dir = _session
    _session[:] = [None, None]
    if sess is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        sess.__exit__(None, None, None)
        _device_events[:] = _session_events(sess)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            sess.export_chrome_trace(os.path.join(
                log_dir, f"torch_trace_{os.getpid()}_{time.time_ns()}.json"))
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(summary(sorted_key or "total") + "\n")


# fluid's 'min'/'max' sort keys are NOT accepted: per-event min/max are
# not tracked here, and silently sorting by total instead would misreport
_SUMMARY_KEYS = {
    "calls": lambda cnt, tot: cnt,
    "total": lambda cnt, tot: tot,
    "avg": lambda cnt, tot: tot / max(cnt, 1),
    "ave": lambda cnt, tot: tot / max(cnt, 1),   # fluid alias for avg
}


def summary(sorted_by="total"):
    """Host-event table, sorted DESC by ``sorted_by`` ('calls' | 'total'
    | 'avg')."""
    keyfn = _SUMMARY_KEYS.get(sorted_by or "total")
    if keyfn is None:
        raise ValueError(f"summary: sorted_by must be one of "
                         f"{sorted(_SUMMARY_KEYS)}, got {sorted_by!r}")
    rows = sorted(_events.items(), key=lambda kv: -keyfn(kv[1][0], kv[1][1]))
    lines = [f"{'Event':<40} {'Calls':>8} {'Total(ms)':>12} {'Avg(ms)':>12}"]
    for name, (count, total) in rows:
        lines.append(f"{name:<40} {count:>8} {total * 1e3:>12.3f} "
                     f"{total * 1e3 / max(count, 1):>12.3f}")
    return "\n".join(lines)


def chrome_trace_doc() -> dict:
    """The chrome-trace document as a dict: the host timeline (pid 0)
    and the last finished session's operator and kernel events (their
    own pids, on the profiler's clock)."""
    events = [{"name": name, "ph": "X", "ts": ts, "dur": dur,
               "pid": 0, "tid": tid % 100000, "cat": "host"}
              for name, ts, dur, tid in _timeline]
    events += [dict(e) for e in _device_events]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _write_chrome_trace(path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace_doc(), f)
    return path


def export_chrome_tracing(path: str, worker_name: Optional[str] = None):
    """Chrome-trace exporter, two forms (chrome://tracing / Perfetto
    JSON).

    - Direct: a ``*.json`` path writes the current trace NOW and returns
      the path.
    - Handler factory (paddle.profiler.export_chrome_tracing parity): any
      other path is a directory, and a callable is returned for
      ``Profiler(on_trace_ready=...)``; each closed record window writes
      ``<dir>/<worker>_chrome_trace_<n>.json``."""
    if path.endswith(".json"):
        return _write_chrome_trace(path)

    dir_name, worker = path, worker_name or "host"
    counter = [0]

    def handler(prof) -> str:
        os.makedirs(dir_name, exist_ok=True)
        counter[0] += 1
        return _write_chrome_trace(os.path.join(
            dir_name, f"{worker}_chrome_trace_{counter[0]}.json"))

    handler.dir_name = dir_name
    return handler


def export_tensorboard(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready handler: the session's chrome trace goes into
    ``dir_name`` (Profiler adopts it as its ``log_dir``), and each closed
    window also writes the host summary table next to it."""
    counter = [0]

    def handler(prof) -> str:
        os.makedirs(dir_name, exist_ok=True)
        counter[0] += 1
        path = os.path.join(
            dir_name, f"{worker_name or 'host'}_summary_{counter[0]}.txt")
        with open(path, "w") as f:
            f.write(summary() + "\n")
        return path

    handler.log_dir = dir_name
    return handler


@contextlib.contextmanager
def profiler(state="All", tracer_option="Default", log_dir=None,
             sorted_key="total"):
    """fluid.profiler.profiler context analogue."""
    start_profiler(state, tracer_option, log_dir)
    try:
        yield
    finally:
        stop_profiler()
        print(summary(sorted_key))


def profile_train_step(step, batch, iters: int = 10, warmup: int = 2):
    """Attribute a TrainStep's wall time: the first call (which builds
    the kernel libraries on the card) vs host prep vs dispatch vs the
    step on the card.

    Returns a dict:
      compile_s       time of the first call, the kernels' build included
      host_ms         placing the batch on the device, per step
      dispatch_ms     time for step() to RETURN (launches queued)
      step_ms         full step latency (synced on the loss)
      device_ms_est   step_ms minus host prep (>= 0)
    """
    def readback(loss):
        return float(loss)

    t0 = time.perf_counter()
    readback(step(*batch))
    compile_s = time.perf_counter() - t0

    for _ in range(warmup):
        step(*batch)
    readback(step(*batch))

    t0 = time.perf_counter()
    for _ in range(iters):
        [step._place(b) for b in batch]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3

    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step(*batch)
    dispatch_ms = (time.perf_counter() - t0) / iters * 1e3
    readback(loss)

    t0 = time.perf_counter()
    for _ in range(iters):
        readback(step(*batch))
    step_ms = (time.perf_counter() - t0) / iters * 1e3

    return {
        "compile_s": compile_s,
        "host_ms": host_ms,
        "dispatch_ms": dispatch_ms,
        "step_ms": step_ms,
        "device_ms_est": max(0.0, step_ms - host_ms),
    }


class ProfilerState:
    """paddle.profiler.ProfilerState parity: the per-step scheduler
    states. RECORD_AND_RETURN marks the LAST record step of a window —
    the step after it closes the window and fires on_trace_ready."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget:
    """paddle.profiler.ProfilerTarget parity tokens. A session records
    the CPU and, where a card is present, the GPU together; targets are
    accepted and recorded for API parity."""
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0):
    """paddle.profiler.make_scheduler parity: a step->ProfilerState
    function cycling CLOSED(closed) -> READY(ready) -> RECORD(record),
    with the window's last record step flagged RECORD_AND_RETURN.
    ``repeat=0`` cycles forever; ``skip_first`` steps are CLOSED before
    the first cycle."""
    if record <= 0:
        raise ValueError("make_scheduler: record must be >= 1")
    if closed < 0 or ready < 0 or repeat < 0 or skip_first < 0:
        raise ValueError("make_scheduler: closed/ready/repeat/skip_first "
                         "must be >= 0")
    cycle = closed + ready + record

    def scheduler(step: int) -> int:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        return (ProfilerState.RECORD_AND_RETURN if pos == cycle - 1
                else ProfilerState.RECORD)

    return scheduler


class Profiler:
    """paddle.profiler.Profiler parity over ``torch.profiler`` and the
    host aggregation above.

    ``scheduler`` is a step->ProfilerState callable (see
    :func:`make_scheduler`) or a ``(start, end)`` tuple recording steps in
    ``[start, end)``; None records everything between start() and stop().
    Each closed record window fires ``on_trace_ready(self)`` (see
    :func:`export_chrome_tracing` / :func:`export_tensorboard` for
    handler factories). ``step()`` advances the schedule — call it once
    per training step.
    """

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 log_dir=None, timer_only=False):
        self.targets = list(targets) if targets else [ProfilerTarget.CPU]
        if isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            if not (0 <= start < end):
                raise ValueError(f"scheduler tuple must be 0 <= start < "
                                 f"end, got {scheduler!r}")
            scheduler = make_scheduler(closed=start, ready=0,
                                       record=end - start, repeat=1)
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        # a TensorBoard handler carries the dir it wants traces in
        self.log_dir = getattr(on_trace_ready, "log_dir", None) or log_dir
        self.timer_only = timer_only
        self.step_num = 0
        self.state = ProfilerState.CLOSED
        self._recording = False
        self.windows = 0          # closed record windows so far

    # -- window plumbing ---------------------------------------------------
    def _begin_window(self):
        if self._recording:
            return
        start_profiler(log_dir=None if self.timer_only else self.log_dir)
        self._recording = True

    def _end_window(self):
        if not self._recording:
            return
        stop_profiler()
        self._recording = False
        self.windows += 1
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def _apply(self, state: int):
        if state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._begin_window()
        elif self._recording:
            self._end_window()
        self.state = state

    # -- public API --------------------------------------------------------
    def start(self):
        self.step_num = 0
        self._apply(self.scheduler(0) if self.scheduler
                    else ProfilerState.RECORD)
        return self

    def step(self, num_samples=None):
        """Advance one training step; closes a window right after its
        RECORD_AND_RETURN step, per the reference scheduler contract."""
        if self.state == ProfilerState.RECORD_AND_RETURN:
            self._end_window()
        self.step_num += 1
        if self.scheduler is not None:
            self._apply(self.scheduler(self.step_num))

    def stop(self):
        # a window open at stop() is exported like any other: partial
        # data beats silently discarding everything recorded so far
        self._end_window()
        self.state = ProfilerState.CLOSED

    def summary(self, sorted_by="total"):
        return summary(sorted_by)

    def export(self, path: str, format: str = "json") -> str:
        """Write the newest window as a chrome trace (format 'json';
        paddle's Profiler.export parity)."""
        if format != "json":
            raise ValueError(f"export: only 'json' (chrome trace) is "
                             f"supported, got {format!r}")
        return _write_chrome_trace(path)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
