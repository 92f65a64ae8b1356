"""The port's serving resilience plane (``paddle_tpu_torch.serving``:
deadlines, priorities and the queue policies, cancel, overload
shedding, graceful drain with snapshots, the dispatch watchdog, the
``/readyz`` states, the load generator's draws and token bucket)
against the JAX package on the CPU.

Each scenario of ``tests/test_serving_resilience.py`` runs on both
packages: ``gpt_tiny`` engines from one numpy seed (the JAX model's
weights carried into the port by ``models.convert``), or the two
schedulers alone. Outcomes, scheduler stats, terminal counts,
``serve_requests_total`` events, readiness states and greedy tokens
must be equal. The port's guarded dispatch runs on its worker thread
without grad mode, and a trip's ``retry_safe`` says whether the job had
passed its launch gate.

Tolerances: none, every comparison is exact. The watchdog cases use
budgets of 0.2-0.5 s.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_resilience.py``.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu import monitor as jmon
from paddle_tpu.core.flags import flag_scope as jflag_scope
from paddle_tpu.monitor import flight_recorder as jflight
from paddle_tpu.serving import resilience as jres
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.testing import chaos as jchaos
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_weights
from paddle_tpu_torch.monitor import flight_recorder as tflight
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.serving import resilience as tres
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.testing import chaos as tchaos

WIDE = dict(hidden_size=128, num_heads=2, initializer_range=0.3)
# the JAX tests' engine: 3 slots, 4-token pages, buckets 8 and 16
CFG = dict(max_batch_slots=3, block_size=4, max_context_len=64,
           prefill_buckets=(8, 16), batch_buckets=(1, 2))


@pytest.fixture(autouse=True)
def _port_isolation():
    """The port's process-global state around each case: chaos, the
    flight recorder, the tracer and the live engines (their drain
    latches' signal handlers, abandoned watchdog threads)."""
    def reset():
        tchaos.reset()
        tflight.set_flight_recorder(None)
        ttrace.set_tracer(None)
        tserving.reset()
    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def models():
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**WIDE))
    jm.eval()
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jm, load_jax_weights(GPTForPretraining(gpt_tiny(**WIDE),
                                                  device="cpu"), named)


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Side:
    """One package's serving surface, so a scenario runs on both."""

    def __init__(self, name, models):
        self.name = name
        if name == "jax":
            self.serving, self.res, self.sched = jserving, jres, jsched
            self.chaos, self.flag_scope, self.mon = jchaos, jflag_scope, jmon
            self.model, self.kw = models[0], {}
        else:
            self.serving, self.res, self.sched = tserving, tres, tsched
            self.chaos, self.flag_scope, self.mon = tchaos, flag_scope, tmon
            self.model, self.kw = models[1], {"device": "cpu"}
        self.Request = self.serving.Request

    def engine(self, clock=None, **kw):
        cfg = dict(CFG, **kw)
        extra = dict(self.kw)
        if clock is not None:
            extra["clock"] = clock
        return self.serving.ServingEngine(
            self.model, self.serving.ServingConfig(**cfg), **extra)

    def host_scheduler(self, policy="reject-new", max_queue=2, max_slots=2,
                       num_pages=12, on_event=None, clock=None):
        cache_cls = JaxPagedKVCache if self.name == "jax" else PagedKVCache
        extra = {} if self.name == "jax" else {"device": "cpu"}
        cache = cache_cls(1, 1, 4, num_pages=num_pages, block_size=4,
                          max_slots=max_slots, max_blocks_per_slot=6, **extra)
        kw = {"clock": clock} if clock is not None else {}
        return self.serving.Scheduler(
            cache, self.serving.BucketTable((8, 16, 24), (1, 2)),
            max_queue=max_queue, policy=policy, on_event=on_event, **kw)


def both(models, fn):
    """``fn(side)`` on the JAX package, then on the port; both results."""
    out = [fn(Side(name, models)) for name in ("jax", "port")]
    jchaos.reset()
    tchaos.reset()
    return out


def _events(reg):
    c = reg.get("serve_requests_total")
    return {} if c is None else {lab["event"]: v for lab, v in c.samples()}


def _prompt(rng, n):
    return rng.integers(2, 250, (n,)).astype(np.int32)


def _prompts(rng, n, lo=4, hi=10):
    return [_prompt(rng, int(rng.integers(lo, hi + 1))) for _ in range(n)]


# -- deadlines and cancel -----------------------------------------------------------
def test_queued_deadline_expires_before_any_slot(models):
    def run(s):
        clock = ManualClock()
        eng = s.engine(clock=clock, max_batch_slots=1)
        rng = np.random.default_rng(0)
        busy = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=8))
        doomed = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=4,
                                      deadline_s=0.5))
        eng.step()
        clock.advance(1.0)
        with s.mon.scoped_registry() as reg:
            eng.run()
        assert doomed.generated == [] and doomed.slot is None
        assert eng.cache.allocator.pages_in_use == 0
        return (busy.outcome, doomed.outcome, busy.generated,
                dict(eng.scheduler.stats), _events(reg))
    j, t = both(models, run)
    assert t == j
    assert t[:2] == ("completed", "expired") and t[3]["expired_queued"] == 1


def test_inflight_deadline_cancelled_at_boundary_pages_freed(models):
    def run(s):
        clock = ManualClock()
        eng = s.engine(clock=clock)
        rng = np.random.default_rng(1)
        keep = eng.submit(s.Request(_prompt(rng, 6), max_new_tokens=6))
        doomed = eng.submit(s.Request(_prompt(rng, 6), max_new_tokens=6,
                                      deadline_s=0.5))
        eng.step()
        in_use = eng.cache.allocator.pages_in_use
        clock.advance(1.0)
        eng.step()
        freed = eng.cache.allocator.pages_in_use < in_use
        eng.run()
        return (keep.outcome, doomed.outcome, keep.generated,
                doomed.generated, freed, dict(eng.scheduler.stats))
    j, t = both(models, run)
    assert t == j
    assert t[:2] == ("completed", "expired") and t[4]
    assert t[5]["expired_queued"] == 0 and len(t[3]) >= 1


def test_deadline_slack_histogram_only_for_deadline_requests(models):
    def run(s):
        eng = s.engine()
        rng = np.random.default_rng(2)
        with s.mon.scoped_registry() as reg:
            eng.generate([_prompt(rng, 5)], max_new_tokens=2)
            before = reg.get("serve_deadline_slack_seconds")
            eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=2,
                                 deadline_s=60.0))
            eng.run()
            h = reg.get("serve_deadline_slack_seconds")
            return before is None, h.count()
    j, t = both(models, run)
    assert t == j == (True, 1)


def test_cancel_queued_and_inflight(models):
    def run(s):
        eng = s.engine(max_batch_slots=1)
        rng = np.random.default_rng(3)
        stream = []
        running = eng.submit(s.Request(
            _prompt(rng, 5), max_new_tokens=8,
            on_token=lambda r, t, txt: stream.append(t)))
        queued = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=8))
        eng.step()
        hits = [eng.cancel(queued.request.request_id)]
        q_now = queued.outcome
        hits.append(eng.cancel(running.request.request_id))
        r_now = running.outcome
        n_at_cancel = len(stream)
        eng.run()
        hits += [eng.cancel(queued.request.request_id), eng.cancel(987654)]
        assert eng.cache.allocator.pages_in_use == 0
        return (hits, q_now, r_now, running.outcome, n_at_cancel,
                list(stream), dict(eng.scheduler.stats))
    j, t = both(models, run)
    assert t == j
    assert t[:4] == ([True, True, False, False], "cancelled", None,
                     "cancelled")
    assert len(t[5]) == t[4]                      # the stream stopped


# -- admission control and the queue policies ----------------------------------------
def _fill(sched, s, n=2):
    sts = [sched.submit(s.Request([1, 2, 3], max_new_tokens=4))
           for _ in range(n)]
    sched.plan_admissions()
    return sts


def _policy_run(s, policy):
    events = []
    sched = s.host_scheduler(policy=policy, max_queue=2,
                             on_event=lambda ev, st: events.append(ev))
    _fill(sched, s)
    sts, refused = [], []
    for prompt, prio in (([1, 2], 0), ([3, 4], 5), ([5, 6], 9),
                         ([7, 8], 5), ([9, 9], 0)):
        try:
            sts.append(sched.submit(s.Request(prompt, max_new_tokens=2,
                                              priority=prio)))
        except s.res.ServerOverloaded as e:
            refused.append((prompt, e.reason, e.queue_depth))
    return ([st.outcome for st in sts],
            [st.request.prompt.tolist() for st in sched.waiting],
            refused, events, dict(sched.stats))


@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest", "priority"])
def test_queue_policies_shed_the_same_victims(models, policy):
    """A full queue of two under each policy: the same newcomers are
    refused (``queue_full``), the same waiters shed, and the queue holds
    the same requests in the same order (priority lanes FIFO on ties)."""
    j, t = both(models, lambda s: _policy_run(s, policy))
    assert t == j
    if policy == "reject-new":
        assert [r[1] for r in t[2]] == ["queue_full"] * 3
    elif policy == "drop-oldest":
        assert t[0][:3] == ["shed", "shed", "shed"] and t[2] == []
    else:
        assert t[1] == [[5, 6], [3, 4]] and t[0][0] == "shed"


def test_expired_waiters_do_not_hold_queue_capacity(models):
    def run(s):
        clock = ManualClock()
        sched = s.host_scheduler(max_queue=2, clock=clock)
        _fill(sched, s)
        dead = [sched.submit(s.Request([1, 2], max_new_tokens=2,
                                       deadline_s=0.5)) for _ in range(2)]
        clock.advance(1.0)
        live = sched.submit(s.Request([3, 4], max_new_tokens=2))
        return ([st.outcome for st in dead], live.outcome,
                live in sched.waiting, dict(sched.stats))
    j, t = both(models, run)
    assert t == j
    assert t[:3] == (["expired", "expired"], None, True) and t[3]["shed"] == 0


def test_oldest_waiting_under_priority_lanes(models):
    def run(s):
        clock = ManualClock()
        sched = s.host_scheduler(policy="priority", max_queue=4,
                                 clock=clock)
        _fill(sched, s)
        old_low = sched.submit(s.Request([1, 2], max_new_tokens=2,
                                         priority=0))
        clock.advance(3.0)
        fresh = sched.submit(s.Request([3, 4], max_new_tokens=2,
                                       priority=5))
        return (sched.waiting[0] is fresh,
                sched.oldest_waiting_t() == old_low.submitted_t,
                sched.oldest_waiting_t())
    j, t = both(models, run)
    assert t == j == (True, True, 0.0)


def test_scheduler_fuzz_invariants_match_jax(models):
    """Random interleavings of submit, admission, decode, cancel,
    expiry, failure and drain release on both schedulers: the same
    outcomes and stats, one terminal event a request, no page leaked."""
    def run(s):
        clock = ManualClock()
        events = []
        sched = s.host_scheduler(max_queue=32, max_slots=3, num_pages=12,
                                 on_event=lambda ev, st: events.append(ev),
                                 clock=clock)
        rng = np.random.default_rng(1234)
        submitted = []
        for _ in range(200):
            op = rng.integers(0, 7)
            clock.advance(float(rng.random()) * 0.2)
            if op == 0:
                plen = int(rng.integers(1, 9))
                deadline = (float(rng.uniform(0.1, 3.0))
                            if rng.random() < 0.3 else None)
                try:
                    submitted.append(sched.submit(s.Request(
                        rng.integers(1, 99, (plen,)),
                        max_new_tokens=int(rng.integers(1, 9)),
                        deadline_s=deadline)))
                except s.res.ServerOverloaded:
                    pass
            elif op == 1:
                sched.plan_admissions()
            elif op == 2:
                sched.ensure_decode_capacity()
                for _, st in list(sched.active()):
                    st.generated.append(int(rng.integers(1, 99)))
                    if st.is_done():
                        sched.finish(st)
            elif op == 3 and submitted:
                st = submitted[int(rng.integers(0, len(submitted)))]
                sched.cancel(st.request.request_id)
            elif op == 4:
                sched.expire_queued()
                sched.sweep_active()
            elif op == 5:
                act = sched.active()
                if act:
                    sched.fail(act[int(rng.integers(0, len(act)))][1], "fuzz")
            elif op == 6:
                pool = sched.waiting + [st for _, st in sched.active()]
                if pool and rng.random() < 0.2:
                    sched.drain_release(pool[int(rng.integers(0, len(pool)))])
        while sched.has_work:
            sched.plan_admissions()
            sched.ensure_decode_capacity()
            for _, st in list(sched.active()):
                st.generated.append(1)
                if st.is_done():
                    sched.finish(st)
            sched.expire_queued()
            sched.sweep_active()
        assert sched.cache.allocator.pages_in_use == 0
        assert len(events) == len(submitted)
        assert all(st.finished == (st.outcome == "completed")
                   for st in submitted)
        return [st.outcome for st in submitted], dict(sched.stats)
    j, t = both(models, run)
    assert t == j
    assert set(t[0]) <= set(tsched.TERMINAL_OUTCOMES)
    assert tsched.TERMINAL_OUTCOMES == jsched.TERMINAL_OUTCOMES
    assert tsched.QUEUE_POLICIES == jsched.QUEUE_POLICIES


# -- overload --------------------------------------------------------------------------
def test_overload_detector_hysteresis(models):
    def run(s):
        det = s.res.OverloadDetector(threshold_s=1.0, alpha=1.0,
                                     exit_frac=0.5)
        return [(det.observe(x), det.overloaded)
                for x in (0.2, 1.5, 1.2, 0.7, 0.3)]
    j, t = both(models, run)
    assert t == j
    assert [x[0] for x in t] == [None, "enter", None, None, "exit"]
    for bad in (dict(threshold_s=0.0), dict(threshold_s=1.0, alpha=0.0),
                dict(threshold_s=1.0, exit_frac=1.0)):
        with pytest.raises(ValueError):
            tres.OverloadDetector(**bad)


def test_overload_shedding_and_readiness_on_engine(models):
    def run(s):
        clock = ManualClock()
        eng = s.engine(clock=clock, max_batch_slots=1,
                       overload_threshold_s=1.0, overload_alpha=1.0)
        rng = np.random.default_rng(4)
        with s.mon.scoped_registry() as reg:
            eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=3))
            stuck = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=3))
            eng.step()
            clock.advance(5.0)
            eng.step()
            ready = eng._readiness()
            gauge = reg.get("serve_overload").value()
            with pytest.raises(s.res.ServerOverloaded) as ei:
                eng.submit(s.Request(_prompt(rng, 4), max_new_tokens=2))
            eng.run()
            for _ in range(8):
                eng.step()
            tr = reg.get("serve_overload_transitions_total")
            out = (ready["state"], ready["threshold_s"], gauge,
                   ei.value.reason, stuck.outcome, stuck.generated,
                   eng._overload.overloaded,
                   reg.get("serve_overload").value(),
                   tr.value(state="enter"), tr.value(state="exit"),
                   _events(reg), eng._readiness())
        eng.submit(s.Request(_prompt(rng, 4), max_new_tokens=2))
        eng.run()
        return out
    j, t = both(models, run)
    assert t == j
    assert t[:5] == ("shedding", 1.0, 1.0, "overload", "completed")
    assert t[6:10] == (False, 0.0, 1.0, 1.0) and t[11] is None


def test_overload_recovers_on_idle_engine(models):
    def run(s):
        clock = ManualClock()
        eng = s.engine(clock=clock, max_batch_slots=1,
                       overload_threshold_s=1.0, overload_alpha=0.3)
        rng = np.random.default_rng(6)
        eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=2))
        stuck = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=2))
        eng.step()
        clock.advance(5.0)
        eng.step()
        tripped = eng._overload.overloaded
        eng.run()
        refusals = 0
        st = None
        for _ in range(17):
            try:
                st = eng.submit(s.Request(_prompt(rng, 4), max_new_tokens=2))
                break
            except s.res.ServerOverloaded:
                refusals += 1
        eng.run()
        return (tripped, stuck.outcome, refusals, st.outcome, st.generated,
                eng._overload.overloaded)
    j, t = both(models, run)
    assert t == j
    assert t[0] and t[1] == t[3] == "completed" and t[2] >= 1
    assert not t[5]


# -- the dispatch watchdog ------------------------------------------------------------
def test_watchdog_converts_hang_into_structured_error(models):
    """``serve.decode.hang@1`` under a 0.4 s budget: the same structured
    error (kind, budget, active slots, retry-safe), trip counter, flight
    events and readiness state in both; the retried run's tokens equal
    the JAX engine's, and readiness clears once a dispatch returns."""
    def run(s):
        rng = np.random.default_rng(9)
        with s.flag_scope("serve_watchdog_s", 0.4), \
                s.flag_scope("flight_recorder", True), \
                s.chaos.chaos_scope("serve.decode.hang@1"):
            eng = s.engine()
            st = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=4))
            with s.mon.scoped_registry() as reg:
                with pytest.raises(s.res.DecodeWatchdogError) as ei:
                    eng.run()
                trips = reg.get("serve_watchdog_trips_total").value(
                    kind="decode")
            ready = eng._readiness()
            fr = jflight if s.name == "jax" else tflight
            names = [e.get("event")
                     for e in fr.get_flight_recorder().events]
            eng.run()
            e = ei.value
            return ((e.kind, e.timeout_s, e.active_slots, e.retry_safe),
                    trips, ready["state"], ready["kind"],
                    "decode_watchdog" in names, "trip" in names,
                    st.outcome, st.generated, eng._readiness())
    j, t = both(models, run)
    assert t == j
    assert t[0] == ("decode", 0.4, 1, True) and t[1] == 1
    assert t[2:6] == ("watchdog-tripped", "decode", True, True)
    assert t[6] == "completed" and t[8] is None


def test_hang_without_watchdog_budget_is_loud(models):
    def run(s):
        with s.chaos.chaos_scope("serve.decode.hang@1"):
            eng = s.engine()
            eng.submit(s.Request(_prompt(np.random.default_rng(10), 5),
                                 max_new_tokens=2))
            with pytest.raises(RuntimeError, match="serve_watchdog_s"):
                eng.run()
        return True
    assert both(models, run) == [True, True]


def test_watchdog_reuses_one_dispatcher_thread(models):
    def run(s):
        with s.flag_scope("serve_watchdog_s", 30.0):
            eng = s.engine()
            st = eng.submit(s.Request(_prompt(np.random.default_rng(23), 5),
                                      max_new_tokens=4))
            eng.run()
        out = (st.outcome, st.generated, eng._stats["prefill_dispatches"],
               eng._stats["decode_dispatches"], len(eng._watchdog_threads),
               eng._watchdog_worker.usable)
        eng.shutdown()
        return out + (eng._watchdog_worker is None,)
    j, t = both(models, run)
    assert t == j
    assert t[0] == "completed" and t[2] + t[3] >= 3 and t[4:] == (1, True,
                                                                  True)


def test_guarded_dispatch_runs_without_grad(models):
    """Grad mode is per thread: the armed watchdog's job runs on the
    worker thread with grad mode off (as the caller's ``step`` has it),
    and gives the unguarded engine's tokens."""
    seen = []
    eng = Side("port", models).engine()
    real = eng._forward

    def spy(*a, **kw):
        seen.append((threading.current_thread().name,
                     torch.is_grad_enabled()))
        return real(*a, **kw)
    eng._forward = spy
    prompt = _prompt(np.random.default_rng(25), 6)
    with flag_scope("serve_watchdog_s", 30.0):
        guarded = eng.generate([prompt], max_new_tokens=3)[0]
    plain = Side("port", models).engine().generate([prompt],
                                                   max_new_tokens=3)[0]
    assert torch.is_grad_enabled()
    assert seen and all(s == ("serve-watchdog-worker", False) for s in seen)
    np.testing.assert_array_equal(guarded, plain)


def _slow_prefill(s, eng, sleep_s):
    """Make the first prefill dispatch sleep ``sleep_s`` before it
    launches anything (JAX: before its program runs)."""
    tripped = []
    if s.name == "jax":
        real_get = eng._get_prefill

        def slow_get(nb, sp):
            prog = real_get(nb, sp)

            def wrapper(*a):
                if not tripped:
                    tripped.append(sp)
                    time.sleep(sleep_s)
                return prog(*a)
            return wrapper
        eng._get_prefill = slow_get
        return lambda: setattr(eng, "_get_prefill", real_get)
    real = eng._forward

    def slow(*a, **kw):
        if not tripped:
            tripped.append(a[0].shape)
            time.sleep(sleep_s)
        return real(*a, **kw)
    eng._forward = slow
    return lambda: setattr(eng, "_forward", real)


def test_prefill_trip_rolls_back_every_unprefilled_group(models):
    """A trip in the first of two planned prefill groups un-admits both:
    nothing holds a slot, nothing counts as a preemption, and the retried
    plan gives the JAX engine's tokens."""
    def run(s):
        rng = np.random.default_rng(24)
        with s.flag_scope("serve_watchdog_s", 0.3):
            eng = s.engine()
            short = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=3))
            long = eng.submit(s.Request(_prompt(rng, 12), max_new_tokens=3))
            restore = _slow_prefill(s, eng, 0.9)
            with pytest.raises(s.res.DecodeWatchdogError) as ei:
                eng.step()
            mid = (ei.value.kind, ei.value.retry_safe, short.slot, long.slot,
                   short.outcome, long.outcome, len(eng.scheduler.waiting),
                   eng.scheduler.stats["preemptions"],
                   eng.cache.allocator.pages_in_use)
            restore()
            eng.run()
        return mid, (short.outcome, long.outcome, short.generated,
                     long.generated)
    j, t = both(models, run)
    assert t == j
    assert t[0] == ("prefill", True, None, None, None, None, 2, 0, 0)
    assert t[1][:2] == ("completed", "completed")


def test_trip_after_the_first_launch_is_not_retry_safe(models):
    """A job that passed its launch gate before it hung may still be
    writing the pools: the trip says ``retry_safe=False`` (the JAX
    engine says True for any non-donating program)."""
    eng = Side("port", models).engine()
    real = eng._sample

    def slow(*a, **kw):
        time.sleep(0.6)
        return real(*a, **kw)
    eng._sample = slow
    eng.submit(tserving.Request(_prompt(np.random.default_rng(5), 5),
                                max_new_tokens=2))
    with flag_scope("serve_watchdog_s", 0.2):
        with pytest.raises(tres.DecodeWatchdogError) as ei:
            eng.step()
    assert ei.value.kind == "prefill" and not ei.value.retry_safe
    assert "CANNOT be retried" in str(ei.value)
    threads = list(eng._watchdog_threads)
    eng.shutdown()
    for th in threads:
        th.join(timeout=2.0)
        assert not th.is_alive()


def test_rollback_releases_adapter_prefix_and_chunk_state(models):
    """A prefill trip on an engine with LoRA, the prefix cache and
    chunked prefill: the rolled-back request holds no adapter reference,
    no page but the tree's and no chunk progress, and its retried run
    gives the untripped engine's tokens."""
    s = Side("port", models)
    rng = np.random.default_rng(31)
    shared = _prompt(rng, 8)
    first = np.concatenate([shared, _prompt(rng, 3)])
    second = np.concatenate([shared, _prompt(rng, 6)])
    a = rng.standard_normal((2, 4, 128)).astype(np.float32) * 0.5
    b = rng.standard_normal((2, 4, 384)).astype(np.float32) * 0.5

    def engine():
        with flag_scope("serve_prefix_cache", True), \
                flag_scope("serve_prefill_chunk", 4):
            eng = s.engine(lora_adapters=2, lora_rank=4)
        eng.lora.load_adapter("x", weights=(a, b))
        eng.generate([first], max_new_tokens=2)   # seeds the tree
        return eng

    ref = engine()
    ref_st = ref.submit(tserving.Request(second, max_new_tokens=3,
                                         adapter="x"))
    ref.run()
    eng = engine()
    cached = eng.cache.allocator.pages_in_use
    st = eng.submit(tserving.Request(second, max_new_tokens=3,
                                     adapter="x"))
    eng.step()                         # admitted on the hit, chunk 1
    assert st.prefill_pos > 8 and eng.lora.refcount("x") == 1
    restore = _slow_prefill(s, eng, 0.6)
    with flag_scope("serve_watchdog_s", 0.2):
        with pytest.raises(tres.DecodeWatchdogError) as ei:
            eng.step()
    assert ei.value.retry_safe
    assert st.slot is None and st.prefill_pos == 0 and st.prefill_len is None
    assert eng.lora.refcount("x") == 0
    assert eng.cache.allocator.pages_in_use == \
        eng.prefix_cache.cached_pages >= cached
    assert eng.scheduler.stats["preemptions"] == 0
    restore()
    eng.run()
    assert st.outcome == "completed" and st.generated == ref_st.generated
    assert eng.lora.refcount("x") == 0


def test_reset_tears_down_abandoned_watchdog_thread(models):
    s = Side("port", models)
    with flag_scope("serve_watchdog_s", 0.2):
        tchaos.configure("serve.decode.hang@1")
        eng = s.engine()
        eng.submit(s.Request(_prompt(np.random.default_rng(11), 5),
                             max_new_tokens=2))
        with pytest.raises(tres.DecodeWatchdogError):
            eng.run()
        threads = list(eng._watchdog_threads)
        assert threads and threads[0].is_alive()
        tserving.reset()
        threads[0].join(timeout=2.0)
        assert not threads[0].is_alive()
        assert eng._watchdog_threads == [] and eng.cache.k is None


def test_reset_restores_drain_signal_handler(models, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    eng = Side("port", models).engine()
    eng.enable_drain(str(tmp_path / "drain"))
    assert signal.getsignal(signal.SIGTERM) is not before
    tserving.reset()
    assert signal.getsignal(signal.SIGTERM) is before
    assert eng._drain_latch is None


# -- graceful drain ------------------------------------------------------------------
def _spec_key(spec):
    return {k: v for k, v in spec.items() if k != "request_id"}


def test_sigterm_drain_zero_lost_and_successor_resumes(models, tmp_path):
    """SIGTERM latched mid-run: both engines drain the same requests
    into equal snapshots, each loadable by the other package's reader,
    and each package's successor resumes them to the uninterrupted JAX
    run's tokens."""
    rng = np.random.default_rng(12)
    prompts = _prompts(rng, 5, 5, 8)
    golden = Side("jax", models).engine(max_batch_slots=2).generate(
        prompts, max_new_tokens=6)

    def run(s):
        root = str(tmp_path / s.name)
        eng = s.engine(max_batch_slots=2)
        eng.enable_drain(root, budget_s=0.0)
        sts = [eng.submit(s.Request(p, max_new_tokens=6)) for p in prompts]
        eng.step()
        os.kill(os.getpid(), signal.SIGTERM)
        draining = eng._readiness()["state"]
        with pytest.raises(s.res.EngineDrained) as ei:
            eng.run()
        report = ei.value.report
        with pytest.raises(s.res.ServerOverloaded) as shed:
            eng.submit(s.Request([1, 2], max_new_tokens=2))
        assert eng.cache.allocator.pages_in_use == 0
        path, specs = s.res.load_drain_snapshot(root)
        assert path == report.path
        eng2 = s.engine(max_batch_slots=2)
        by_id = {st.request.request_id: i for i, st in enumerate(sts)}
        sts2 = [eng2.submit(r)
                for r in s.res.requests_from_snapshot(specs)]
        eng2.run()
        for spec, st2 in zip(specs, sts2):
            full = np.concatenate([spec["prompt"], spec["generated"],
                                   st2.generated]).astype(np.int32)
            np.testing.assert_array_equal(full, golden[by_id[spec["request_id"]]])
        return (draining, eng._readiness()["state"], shed.value.reason,
                [st.outcome for st in sts], report.completed,
                report.snapshotted, [_spec_key(x) for x in specs],
                [st.outcome for st in sts2])
    j, t = both(models, run)
    assert t == j
    assert t[:3] == ("draining", "drained", "draining")
    assert t[5] >= 1 and t[3].count("drained") == t[5]
    assert set(t[7]) == {"completed"}
    # each package reads the other's snapshot
    for reader, root in ((jres.load_drain_snapshot, "port"),
                         (tres.load_drain_snapshot, "jax")):
        _, specs = reader(str(tmp_path / root))
        assert [_spec_key(x) for x in specs] == t[6]


def test_drain_grace_budget_finishes_inflight(models, tmp_path):
    def run(s):
        eng = s.engine(max_batch_slots=2)
        sts = [eng.submit(s.Request(p, max_new_tokens=3))
               for p in _prompts(np.random.default_rng(13), 2, 5, 7)]
        eng.step()
        r = eng.drain(snapshot_dir=str(tmp_path / s.name), budget_s=60.0)
        return ((r.completed, r.snapshotted, r.path),
                [(st.outcome, st.generated) for st in sts])
    j, t = both(models, run)
    assert t == j and t[0] == (2, 0, None)


def test_drain_honours_latched_cancel_not_snapshotted(models, tmp_path):
    def run(s):
        eng = s.engine(max_batch_slots=2)
        rng = np.random.default_rng(26)
        keep = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=8))
        gone = eng.submit(s.Request(_prompt(rng, 5), max_new_tokens=8))
        eng.step()
        eng.cancel(gone.request.request_id)
        r = eng.drain(snapshot_dir=str(tmp_path / s.name), budget_s=0.0)
        _, specs = s.res.load_drain_snapshot(str(tmp_path / s.name))
        return (gone.outcome, keep.outcome, r.snapshotted,
                [_spec_key(x) for x in specs])
    j, t = both(models, run)
    assert t == j and t[:3] == ("cancelled", "drained", 1)


def test_drain_refuses_to_discard_without_snapshot_dir(models):
    def run(s):
        eng = s.engine()
        st = eng.submit(s.Request(_prompt(np.random.default_rng(14), 5),
                                  max_new_tokens=4))
        with pytest.raises(ValueError, match="snapshot_dir"):
            eng.drain(budget_s=0.0)
        return st.outcome, eng._draining
    j, t = both(models, run)
    assert t == j == (None, False)


def test_drain_snapshot_commit_is_atomic_under_torn_write(models, tmp_path):
    def run(s):
        root = str(tmp_path / s.name)
        rng = np.random.default_rng(15)
        eng1 = s.engine()
        eng1.submit(s.Request(_prompt(rng, 5), max_new_tokens=4))
        r1 = eng1.drain(snapshot_dir=root, budget_s=0.0)
        eng2 = s.engine()
        eng2.submit(s.Request(_prompt(rng, 6), max_new_tokens=4))
        with s.chaos.chaos_scope("ckpt.write.torn@1"):
            r2 = eng2.drain(snapshot_dir=root, budget_s=0.0)
        path, specs = s.res.load_drain_snapshot(root)
        return (os.path.basename(r1.path), os.path.basename(r2.path),
                path == r1.path, [_spec_key(x) for x in specs])
    j, t = both(models, run)
    assert t == j and t[:3] == ("drain_1", "drain_2", True)
    assert len(t[3]) == 1


# -- the load generator ------------------------------------------------------------------
def test_loadgen_deadline_and_priority_draws_match_jax(models):
    """``build_requests`` replays the JAX stream with the deadline and
    priority draws in place (after the prefix draw, before the token
    budget), with and without them and with tenants and adapters."""
    base = dict(num_requests=40, rate_rps=100.0, prompt_len_range=(4, 8),
                max_new_range=(2, 4), vocab_size=256, seed=11)
    specs = [dict(deadline_range=(0.5, 2.0), priority_choices=(0, 5)),
             dict(), dict(priority_choices=(0, 1, 2), shared_prefix_len=4,
                          tenants=2, adapter_pool=2, arrival="mmpp",
                          burstiness=2.0)]

    def fields(r):
        return (r.prompt.tolist(), r.max_new_tokens, r.deadline_s,
                r.priority, r.tenant, r.adapter)
    for extra in specs:
        jreqs = jserving.build_requests(jserving.LoadSpec(**base, **extra))
        treqs = tserving.build_requests(tserving.LoadSpec(**base, **extra))
        assert [t for t, _ in treqs] == [t for t, _ in jreqs]
        assert [fields(r) for _, r in treqs] == [fields(r) for _, r in jreqs]
    reqs = [r for _, r in tserving.build_requests(
        tserving.LoadSpec(**base, **specs[0]))]
    assert all(0.5 <= r.deadline_s <= 2.0 for r in reqs)
    assert {r.priority for r in reqs} == {0, 5}


def test_token_bucket_matches_jax():
    times = [0.0, 0.0, 0.0, 1.05, 1.06, 1.5, 3.0, 3.0, 3.0, 3.2]
    got = []
    for mod in (jserving, tserving):
        tb = mod.TokenBucket(rate=1.0, burst=2)
        got.append([tb.admit(x) for x in times])
        with pytest.raises(ValueError):
            mod.TokenBucket(rate=0.0, burst=2)
    assert got[0] == got[1]
    assert got[1][:5] == [True, True, False, True, False]


def test_run_open_loop_counts_rejections_and_throttle(models):
    s = Side("port", models)
    spec = tserving.LoadSpec(num_requests=5, rate_rps=1e5,
                             prompt_len_range=(4, 8), max_new_range=(2, 3),
                             vocab_size=256, seed=12)
    eng = s.engine(max_batch_slots=1, max_queue=1)
    summary = tserving.run_open_loop(eng, spec)
    st = eng.scheduler.stats
    assert (summary["requests_completed"] + summary["requests_rejected"]
            + st["shed"] + st["expired"] + st["failed"]) == 5
    assert summary["requests_rejected"] >= 1
    assert summary["watchdog_trips"] == 0
    assert summary["requests_submitted"] + summary["requests_rejected"] == 5
    eng2 = s.engine(max_batch_slots=1)
    summary2 = tserving.run_open_loop(
        eng2, spec, token_bucket=tserving.TokenBucket(rate=1.0, burst=2))
    assert summary2["requests_throttled"] >= 1
    assert (summary2["requests_completed"] + summary2["requests_throttled"]
            + summary2["requests_rejected"]) == 5


def test_run_open_loop_gives_up_on_persistent_watchdog_trips():
    class _HungEngine:
        class scheduler:
            has_work = True

        def submit(self, request):
            return None

        def step(self):
            raise tres.DecodeWatchdogError("decode", 0.1, 1, 1)

    class _UnsafeEngine(_HungEngine):
        def step(self):
            raise tres.DecodeWatchdogError("decode", 0.1, 1, 1,
                                           retry_safe=False)

    spec = tserving.LoadSpec(num_requests=1, rate_rps=1e6,
                             prompt_len_range=(4, 4), max_new_range=(2, 2),
                             vocab_size=64, seed=0)
    for eng in (_HungEngine(), _UnsafeEngine()):
        with pytest.raises(tres.DecodeWatchdogError):
            tserving.run_open_loop(eng, spec)


# -- off means off ---------------------------------------------------------------------
def test_resilience_off_adds_no_registry_series_or_dispatches(models):
    """With every resilience knob at its default, both engines write the
    same registry series (none of the resilience ones), see only the
    submitted and completed events and make the same dispatches; the
    port's engine starts no watchdog thread."""
    def run(s):
        rng = np.random.default_rng(17)
        prompts = [_prompt(rng, 6) for _ in range(2)]
        with s.mon.scoped_registry() as reg:
            eng = s.engine()
            out = eng.generate(prompts, max_new_tokens=4)
            names = set(reg.names())
        return (sorted(n for n in names if n.startswith(
                    ("serve_overload", "serve_deadline", "serve_watchdog",
                     "slo_"))),
                _events(reg), eng._stats["prefill_dispatches"],
                eng._stats["decode_dispatches"], eng._watchdog_worker,
                [o.tolist() for o in out], s.chaos.occurrences(
                    "serve.pages.exhaust"))
    j, t = both(models, run)
    assert t == j
    assert t[:5] == ([], {"submitted": 2.0, "completed": 2.0}, 1, 3, None)
