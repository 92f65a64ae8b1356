"""Deterministic chaos injection: named fault sites the recovery paths
are proven against.

Production fault tolerance that has never seen a fault is a guess. This
module puts *named probe sites* on the framework's recovery-relevant
code paths; a test (or ``chip_smoke.py``) arms a subset of them with
a deterministic plan, and the site fires exactly where and when the plan
says — so every recovery path (torn-checkpoint fallback, collective
timeout, skip-and-continue, elastic restart) is exercised reproducibly
instead of waiting for production to exercise it for you.

Built-in sites (``register_site`` adds more):

- ``ckpt.write.torn``       truncate a checkpoint data file AFTER its
                            manifest checksum was recorded (a torn write
                            racing the commit) — verification must catch
                            it and ``latest_step`` must fall back.
- ``ckpt.manifest.corrupt`` scribble over the committed manifest — the
                            directory must read as invalid, never as an
                            empty-but-plausible checkpoint.
- ``collective.hang``       an eager collective dispatch blocks (bounded
                            sleep, cancellable) — the
                            ``FLAGS_collective_timeout_s`` watchdog must
                            convert it into ``CollectiveTimeoutError``.
- ``grad.nonfinite``        the TrainStep loss comes back NaN — the
                            ``skip_nonfinite_budget`` policy must skip
                            the update and continue.
- ``worker.die``            the training process dies at a step boundary
                            (raises :class:`ChaosFault` from
                            ``CheckpointManager.on_step``) — elastic
                            restart must resume from the last commit.

Plans are armed via :func:`configure` with a spec string (also read from
``FLAGS_chaos`` / ``FLAGS_chaos_seed`` on first probe), or
programmatically via :func:`arm`:

    site            fire on every occurrence
    site@N          fire on the N-th occurrence (1-based) only
    site:p          fire with probability p per occurrence —
                    deterministic in (seed, site, occurrence)
    ...*k           cap total fires at k

``probe(site)`` is the hook the framework calls: it counts the
occurrence and answers "does the fault fire here, now?". Disarmed
(default), :func:`active` is a single cached-bool check — the probe
sites cost nothing in production. Every fire lands in the
flight-recorder event log (when recording is enabled) so chaos runs
leave the same forensics a real fault would.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SITES", "ChaosFault", "register_site", "configure", "arm",
           "active", "probe", "fired", "occurrences", "reset",
           "cancel_hangs", "rearm_hangs", "hang_loop", "chaos_scope"]

# site -> one-line description (the registry doubles as typo protection:
# arming or probing an unknown site is a bug in the caller, not a fault)
SITES: Dict[str, str] = {
    "ckpt.write.torn": "truncate a checkpoint file after its checksum "
                       "was recorded, before the commit rename",
    "ckpt.manifest.corrupt": "scribble over the committed checkpoint "
                             "manifest",
    "collective.hang": "block an eager collective dispatch (bounded, "
                       "cancellable sleep)",
    "grad.nonfinite": "replace the TrainStep loss with NaN",
    "worker.die": "kill the training loop at a step boundary",
    # serving sites (probed by serving/ — built in so a run can arm
    # them before the serving import)
    "serve.decode.hang": "block a serving decode dispatch (bounded, "
                         "cancellable sleep) — the FLAGS_serve_watchdog_s "
                         "watchdog must convert it into "
                         "DecodeWatchdogError",
    "serve.request.poison": "poison a submitted request: its sampled "
                            "logits row turns non-finite, so fault "
                            "isolation must fail ONLY that slot",
    "serve.pages.exhaust": "pretend the KV page pool ran dry for one "
                           "scheduler decision: admission waits / the "
                           "newest-admitted request is recompute-"
                           "preempted",
    "serve.detok.raise": "raise from the streaming detokenizer/on_token "
                         "callback of one accepted token",
    # model-lifecycle sites (probed by the JAX package's hot swap; the
    # port keeps the registry whole so one spec arms both packages)
    "serve.swap.torn_manifest": "a candidate weight push reads as torn "
                                "at verification time: swap_weights "
                                "must refuse it and the OLD weights "
                                "keep serving",
    "serve.swap.bad_weights": "plant non-finite values into a loaded "
                              "candidate param tree AFTER verification "
                              "(the corruption manifests as NaN logits "
                              "in flight — the auto-rollback drill)",
    "serve.swap.replica_die_mid_swap": "the candidate replica dies "
                                       "while its swap is staged: the "
                                       "lifecycle controller must "
                                       "abort, migrate its in-flight "
                                       "work and leave the baseline "
                                       "untouched",
}


class ChaosFault(RuntimeError):
    """An injected fault that models sudden process death (site
    ``worker.die``); carries the site name for supervisors that want to
    distinguish injected faults from organic ones."""

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"chaos-injected fault at {site!r}")
        self.site = site


def register_site(name: str, description: str = "") -> None:
    """Declare an additional probe site (idempotent)."""
    SITES.setdefault(name, description)


class _Plan:
    __slots__ = ("at", "prob", "times", "fires")

    def __init__(self, at: Optional[int] = None,
                 prob: Optional[float] = None,
                 times: Optional[int] = None):
        if at is not None and at < 1:
            raise ValueError("chaos: @N occurrence index is 1-based")
        if prob is not None and not (0.0 <= prob <= 1.0):
            raise ValueError(f"chaos: probability {prob} outside [0, 1]")
        self.at = at
        self.prob = prob
        # an @N plan is a single shot unless *k says otherwise
        self.times = times if times is not None else (1 if at is not None
                                                      else None)
        self.fires = 0


class ChaosInjector:
    """One process-wide injector; tests swap/inspect it via the module
    functions. All decisions are host-side and deterministic."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self._plans: Dict[str, _Plan] = {}
            self._counts: Dict[str, int] = {}
            self._fired: List[Tuple[str, int]] = []
            self._seed = 0
            self._armed = False
            self._flags_checked = False
            # cancels in-flight hang_loop sleeps so a chaos-hung worker
            # thread exits promptly at test teardown
            self._cancel = threading.Event()

    # -- arming ------------------------------------------------------------
    def configure(self, spec: str, seed: int = 0) -> None:
        """Parse a ``site[@N|:p][*k]`` comma list and arm those plans
        (replacing any current plans)."""
        self.reset()
        self._seed = int(seed)
        self._flags_checked = True
        for raw in (spec or "").split(","):
            entry = raw.strip()
            if not entry:
                continue
            times = None
            if "*" in entry:
                entry, times_s = entry.rsplit("*", 1)
                times = int(times_s)
            at = prob = None
            if "@" in entry:
                entry, at_s = entry.split("@", 1)
                at = int(at_s)
            elif ":" in entry:
                entry, prob_s = entry.rsplit(":", 1)
                prob = float(prob_s)
            self.arm(entry.strip(), at=at, prob=prob, times=times)

    def arm(self, site: str, at: Optional[int] = None,
            prob: Optional[float] = None,
            times: Optional[int] = None) -> None:
        if site not in SITES:
            raise ValueError(
                f"chaos: unknown site {site!r}; known sites: "
                f"{', '.join(sorted(SITES))} (register_site adds more)")
        with self._lock:
            self._plans[site] = _Plan(at=at, prob=prob, times=times)
            self._armed = True
            self._flags_checked = True

    def _load_flags(self) -> None:
        """Pick up FLAGS_chaos / FLAGS_chaos_seed once (first probe)."""
        self._flags_checked = True
        try:
            from ..core.flags import get_flag
            spec = get_flag("chaos")
            seed = int(get_flag("chaos_seed"))
        except Exception:
            return
        if spec:
            self.configure(spec, seed=seed)

    # -- probing -----------------------------------------------------------
    def active(self) -> bool:
        if not self._flags_checked:
            self._load_flags()
        return self._armed

    def probe(self, site: str) -> bool:
        """Count one occurrence of ``site`` and decide whether the armed
        plan fires here. False (and no counting) when disarmed."""
        if not self.active():
            return False
        with self._lock:
            plan = self._plans.get(site)
            if plan is None:
                return False
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            if plan.times is not None and plan.fires >= plan.times:
                return False
            if plan.at is not None:
                fire = n == plan.at
            elif plan.prob is not None:
                fire = random.Random(
                    f"{self._seed}:{site}:{n}").random() < plan.prob
            else:
                fire = True
            if not fire:
                return False
            plan.fires += 1
            self._fired.append((site, n))
        # forensics: a chaos fire is an event a post-mortem must see
        # next to the recovery it triggered
        try:
            from ..monitor import flight_recorder as _flight
            if _flight.enabled():
                _flight.get_flight_recorder().record_event(
                    "chaos", site=site, occurrence=n)
        except Exception:
            pass
        return True

    def hang_loop(self, max_s: float = 60.0) -> None:
        """Cancellable bounded block (site ``collective.hang``): sleeps
        until :meth:`reset` cancels it or ``max_s`` elapses, so a hung
        worker thread never outlives the test that armed it."""
        cancel = self._cancel
        deadline = time.monotonic() + max_s
        while not cancel.is_set() and time.monotonic() < deadline:
            cancel.wait(0.05)


_state = ChaosInjector()


def configure(spec: str, seed: int = 0) -> None:
    _state.configure(spec, seed=seed)


def arm(site: str, at: Optional[int] = None, prob: Optional[float] = None,
        times: Optional[int] = None) -> None:
    _state.arm(site, at=at, prob=prob, times=times)


def active() -> bool:
    """Whether any site is armed (cheap: the hot-path guard)."""
    return _state.active()


def probe(site: str) -> bool:
    return _state.probe(site)


def fired() -> List[Tuple[str, int]]:
    """(site, occurrence) pairs that fired, in order."""
    return list(_state._fired)


def occurrences(site: str) -> int:
    """How many times ``site`` was probed while armed."""
    return _state._counts.get(site, 0)


def cancel_hangs() -> None:
    """Cancel in-flight :func:`hang_loop` sleeps WITHOUT disarming the
    plans (engine/watchdog teardown: abandoned hung worker threads must
    exit promptly even before the test-scope chaos reset runs).
    Subsequent hangs in this arming no-op until :func:`reset` or
    :func:`rearm_hangs`."""
    _state._cancel.set()


def rearm_hangs() -> None:
    """Re-enable hang sites after :func:`cancel_hangs` (one engine's
    shutdown must not neutralize still-armed chaos for other live
    engines). Threads blocked on the old cancel event still exit; new
    :func:`hang_loop` calls honour fresh cancels."""
    _state._cancel = threading.Event()


def reset() -> None:
    """Disarm everything and cancel in-flight hangs (test teardown)."""
    _state._cancel.set()
    _state.reset()
    # reset() marks flags as checked: a FLAGS_chaos value armed for one
    # test must not silently resurrect in the next
    _state._flags_checked = True


def hang_loop(max_s: float = 60.0) -> None:
    _state.hang_loop(max_s)


class chaos_scope:
    """``with chaos_scope("grad.nonfinite@2"):`` — configure on entry,
    reset on exit (the test-local arming idiom)."""

    def __init__(self, spec: str, seed: int = 0):
        self._spec, self._seed = spec, seed

    def __enter__(self):
        configure(self._spec, seed=self._seed)
        return _state

    def __exit__(self, *exc):
        reset()
        return False
