"""The port's model lifecycle (``paddle_tpu_torch.serving``: the engine's
live weight hot-swap, ``lifecycle.py``'s traffic split and promotion
controller, loadgen's lifecycle tags) against the JAX package on the
CPU.

The A/B and shadow draws (``assign_arm`` / ``should_shadow``) and the
loadgen tags must be bit-identical to the JAX package's; the same
sequence of arm outcomes must drive both packages' controllers through
the same transitions to the same decision. On ``gpt_tiny`` engines of
both packages (the JAX model's weights carried into the port by
``models.convert``; each push saved as a checkpoint of its own package
from the same float32 values): a torn or mismatched push refuses with
no side effect, an identity push and its rollback leave greedy tokens
unchanged, a push of DIFFERENT weights staged while requests are in
flight finishes every request admitted before the cutover on the old
weights and every one admitted after on the new (each token-identical
to an engine that serves only those weights), the drain-mode swap
continues token-exactly, and an armed engine that never swaps
dispatches as a disarmed one; in each of these the JAX engine, given
the same push at the same step, gives the same tokens, per-request
weight epochs, refusal reasons, ``metrics_summary()`` swap fields,
admin weights section, ``weights_*`` / ``swap_refused`` flight events
and ``serve_swaps_total`` / ``serve_weights_epoch`` samples. A NaN
candidate (``serve.swap.bad_weights``) is rolled back by the
controller, and three identity pushes under bursty fleet load lose and
duplicate nothing.

Tolerances: none, every comparison is exact.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lifecycle.py``.
"""

import contextlib
import gc
import json
import os
import time
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu import monitor as jmon
from paddle_tpu.core.flags import flag_scope as jflag_scope
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.monitor import flight_recorder as jflight
from paddle_tpu.serving import lifecycle as jlife
from paddle_tpu.testing import chaos as jchaos
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.distributed import checkpoint as dckpt
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_weights
from paddle_tpu_torch.monitor import flight_recorder as tflight
from paddle_tpu_torch.monitor import memory as tmemory
from paddle_tpu_torch.monitor import scoped_registry
from paddle_tpu_torch.serving import lifecycle as tlife
from paddle_tpu_torch.testing import chaos

WIDE = dict(hidden_size=128, num_heads=2, initializer_range=0.3)
CFG = dict(max_batch_slots=3, block_size=4, max_context_len=64,
           prefill_buckets=(8, 16), batch_buckets=(1, 2))
PROMPTS = [[3, 4, 5, 3, 4, 5, 3, 4], [7, 8, 9, 7, 8, 9, 7, 8],
           [1, 2, 1, 2, 1, 2]]
LATE = [[11, 12, 13, 11, 12], [21, 22, 23, 24, 21, 22, 23]]


@pytest.fixture(autouse=True)
def _port_isolation():
    def reset():
        chaos.reset()
        tflight.set_flight_recorder(None)
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


def _engine(model, **kw):
    return tserving.ServingEngine(model, tserving.ServingConfig(
        **dict(CFG, **kw)), device="cpu")


def _armed(model, **kw):
    with flag_scope("serve_hot_swap", True):
        return _engine(model, **kw)


def _fleet(model, n=2, router_kw=None, flags=(), **kw):
    with contextlib.ExitStack() as stack:
        for name, val in flags:
            stack.enter_context(flag_scope(name, val))
        reps = {f"r{i}": _engine(model, **kw) for i in range(n)}
        return tserving.FleetRouter(
            reps, tserving.RouterConfig(**(router_kw or {})))


def _perturbed(params, delta):
    return {k: (t + delta if t.is_floating_point() else t).detach().clone()
            for k, t in params.items()}


def _save_manifest(engine, path, perturb=0.0):
    """The engine's live parameters (shifted by ``perturb``) as a
    committed checkpoint, the shape every push arrives in."""
    dckpt.save(_perturbed(engine.params, perturb), str(path),
               asynchronous=False)
    return str(path)


def _model_with(params):
    m = GPTForPretraining(gpt_tiny(**WIDE), device="cpu")
    m.load_state_dict(params)
    return m


def _gen(engine, prompts, n=6):
    return [o.tolist() for o in engine.generate(prompts, max_new_tokens=n)]


class Side:
    """One package's engine, checkpoint, flight recorder and registry,
    so a weight push runs on both from the same weights."""

    def __init__(self, name, models, root):
        self.name, self.root = name, str(root / name)
        if name == "jax":
            self.serving, self.flag_scope, self.mon = (jserving, jflag_scope,
                                                       jmon)
            self.flight, self.model, self.kw = jflight, models[0], {}
            self.chaos = jchaos
        else:
            self.serving, self.flag_scope, self.mon = (tserving, flag_scope,
                                                       tmon)
            self.flight, self.model = tflight, models[1]
            self.kw, self.chaos = {"device": "cpu"}, chaos
        self.Request = self.serving.Request
        self.flight.set_flight_recorder(None)

    def engine(self):
        with self.flag_scope("serve_hot_swap", True):
            return self.serving.ServingEngine(
                self.model, self.serving.ServingConfig(**CFG), **self.kw)

    def save(self, engine, name, delta=0.0):
        """The engine's live tree, every floating leaf shifted by
        ``delta`` (float32 adds, the same bits in both packages), as a
        committed checkpoint of that package."""
        path = os.path.join(self.root, name)
        if self.name == "port":
            dckpt.save(_perturbed(engine.params, delta), path,
                       asynchronous=False)
            return path
        import jax.numpy as jnp
        state = {k: jnp.asarray(a) + jnp.asarray(delta, a.dtype)
                 if jnp.issubdtype(a.dtype, jnp.inexact) else jnp.asarray(a)
                 for k, a in engine.params.items()}
        jckpt.save(state, path, asynchronous=False)
        return path

    def save_arrays(self, name, arrays):
        """A dict of numpy arrays as a committed checkpoint of this
        package."""
        path = os.path.join(self.root, name)
        if self.name == "port":
            dckpt.save({k: torch.from_numpy(np.array(a))
                        for k, a in arrays.items()}, path,
                       asynchronous=False)
        else:
            import jax.numpy as jnp
            jckpt.save({k: jnp.asarray(a) for k, a in arrays.items()},
                       path, asynchronous=False)
        return path

    def clean(self, value):
        """``value`` with this side's checkpoint root cut from its
        strings, request states dropped."""
        if isinstance(value, dict):
            return {k: self.clean(v) for k, v in value.items()
                    if k not in ("ts", "states")}
        if isinstance(value, (list, tuple)):
            return [self.clean(v) for v in value]
        if isinstance(value, str):
            return value.replace(self.root, "<root>")
        return value

    def swap_record(self, eng, reg):
        """What a push leaves to compare: the swap fields of
        ``metrics_summary()``, the admin plane's weights section, the
        ``weights_*`` / ``swap_refused`` flight events and the
        ``serve_swaps_total`` / ``serve_weights_epoch`` samples."""
        summ = eng.metrics_summary()
        events = [e for e in self.flight.get_flight_recorder().events
                  if e["event"].startswith(("weights_", "swap_"))]
        metrics = {n: sorted((sorted(lab.items()), v)
                             for lab, v in reg.get(n).samples())
                   for n in ("serve_swaps_total", "serve_weights_epoch")
                   if reg.get(n) is not None}
        return self.clean({
            "summary": {k: summ[k] for k in (
                "weights_epoch", "weight_swaps", "weight_swaps_refused",
                "weight_swap_rollbacks")},
            "weights": eng._admin_status()["weights"],
            "events": events, "metrics": metrics})


def both(models, tmp_path, fn):
    """``fn(side)`` on the JAX package, then on the port, each with the
    flight recorder on and a registry of its own; both results."""
    out = []
    for name in ("jax", "port"):
        side = Side(name, models, tmp_path)
        with side.flag_scope("flight_recorder", True), \
                side.mon.scoped_registry() as reg:
            out.append(fn(side, reg))
        side.flight.set_flight_recorder(None)
    return out


def _seqs(states):
    return [[int(t) for t in st.request.prompt] + [int(t) for t in
                                                   st.generated]
            for st in states]


# -- the split hashes and loadgen tags ---------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("frac", [0.0, 0.05, 0.3, 1.0])
def test_split_hashes_are_the_jax_ones(seed, frac):
    ids = range(10_000)
    assert [tlife.assign_arm(i, seed, frac) for i in ids] \
        == [jlife.assign_arm(i, seed, frac) for i in ids]
    assert [tlife.should_shadow(i, seed, frac) for i in ids] \
        == [jlife.should_shadow(i, seed, frac) for i in ids]
    assert [tlife._u01("ab", seed, i) for i in range(50)] \
        == [jlife._u01("ab", seed, i) for i in range(50)]


def test_loadgen_tags_match_jax_and_change_nothing_else():
    base = dict(num_requests=16, rate_rps=50.0, seed=3, vocab_size=64)
    tags = dict(ab_split=0.3, shadow_frac=0.5, split_seed=7)
    out = {}
    for name, serving, sched in (
            ("jax", jserving, jserving.scheduler),
            ("port", tserving, tserving.scheduler)):
        sched._reset_request_ids()
        plain = serving.build_requests(serving.LoadSpec(**base))
        sched._reset_request_ids()
        tagged = serving.build_requests(serving.LoadSpec(**base, **tags))
        assert [(t, r.prompt.tolist(), r.max_new_tokens) for t, r in plain] \
            == [(t, r.prompt.tolist(), r.max_new_tokens) for t, r in tagged]
        assert all(not hasattr(r, "lifecycle_arm") for _, r in plain)
        out[name] = [(t, r.prompt.tolist(), int(r.request_id),
                      r.lifecycle_arm, r.lifecycle_shadow)
                     for t, r in tagged]
    assert out["port"] == out["jax"]
    arms = {a for *_, a, _ in out["port"]}
    assert arms == {"baseline", "candidate"}


# -- the controller's state machine against the JAX one --------------------------
class _FakeEngine:
    def __init__(self):
        self._weights_epoch = 0
        self.calls = []

    def swap_weights(self, manifest_dir):
        self.calls.append("swap")
        self._weights_epoch += 1
        return {"mode": "staged", "epoch": self._weights_epoch,
                "pending": False}

    def rollback_weights(self):
        self.calls.append("rollback")
        self._weights_epoch += 1
        return {"mode": "staged", "epoch": self._weights_epoch,
                "pending": False}

    def commit_swap(self):
        self.calls.append("commit")


class _FakeRouter:
    """The router surface the controller drives, with no engines."""

    def __init__(self, n=3):
        self.replicas = {}
        for i in range(n):
            rep = type("Rep", (), {})()
            rep.name, rep.alive, rep.engine = f"r{i}", True, _FakeEngine()
            self.replicas[rep.name] = rep
        self.splits = []

    def replica(self, name):
        return self.replicas.get(name)

    def attach_lifecycle(self, controller):
        self.controller = controller

    def set_traffic_split(self, split):
        self.splits.append(("set", split.candidate, split.ab_frac,
                            split.shadow_frac))

    def clear_traffic_split(self):
        self.splits.append(("clear",))


# (config, [(arm, outcome, e2e, t)], decision ticks)
SCENARIOS = {
    "promoted": (dict(bake_window_s=5.0, min_requests=3),
                 [("candidate", "completed", 0.1, t) for t in (1, 2, 3, 4)],
                 (2.0, 4.5, 6.0)),
    "nonfinite": (dict(bake_window_s=30.0, min_requests=3),
                  [("baseline", "completed", 0.1, 1.0),
                   ("shadow", "failed", 0.2, 1.5)], (1.0, 2.0)),
    "slo_burn": (dict(bake_window_s=30.0, min_requests=4, max_nonfinite=10),
                 [("candidate", "completed", 0.1, 1.0),
                  ("candidate", "expired", 0.1, 1.1),
                  ("shadow", "expired", 0.1, 1.2),
                  ("candidate", "shed", 0.1, 1.3)], (1.05, 1.4)),
    "latency": (dict(bake_window_s=30.0, min_requests=4, max_p99_ratio=1.5),
                [(arm, "completed", 0.5 if arm == "candidate" else 0.1,
                  1.0 + i / 10) for i, arm in enumerate(
                      ["baseline", "candidate"] * 4)], (1.2, 1.9)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decides_as_jax(name):
    cfg, outcomes, ticks = SCENARIOS[name]
    runs = []
    for life, scope in ((jlife, jflag_scope), (tlife, flag_scope)):
        router = _FakeRouter()
        clock = [0.0]
        with scope("serve_lifecycle", True):
            ctrl = life.LifecycleController(
                router, life.LifecycleConfig(**cfg), clock=lambda: clock[0])
        begun = ctrl.begin("/push", candidate="r1",
                           split=life.TrafficSplit(candidate="r1",
                                                   ab_frac=0.25,
                                                   shadow_frac=1.0, seed=3))
        decisions = []
        pending = sorted(outcomes, key=lambda o: o[3])
        for tick in ticks:
            while pending and pending[0][3] <= tick:
                arm, outcome, e2e, t = pending.pop(0)
                ctrl.observe(arm, outcome, e2e, t=t)
            clock[0] = tick
            decisions.append(ctrl.maybe_decide(t=tick))
        summary = json.loads(json.dumps(ctrl.summary(), sort_keys=True,
                                        default=str))
        runs.append((begun, decisions, summary, router.splits,
                     {n: r.engine.calls for n, r in router.replicas.items()}))
    assert runs[1] == runs[0]
    assert runs[1][2]["state"] == ("promoted" if name == "promoted"
                                   else "rolled-back")
    if name != "promoted":
        assert runs[1][2]["decision"]["trigger"] == name


# -- swap_weights on one engine -------------------------------------------------
def test_swap_and_controller_disarmed_with_flags_off(models, tmp_path):
    _, tm = models
    eng = _engine(tm)
    with pytest.raises(RuntimeError, match="serve_hot_swap"):
        eng.swap_weights(str(tmp_path))
    with pytest.raises(RuntimeError, match="serve_hot_swap"):
        eng.rollback_weights()
    assert "weights" not in eng._admin_status()
    router = _fleet(tm)
    with pytest.raises(RuntimeError, match="serve_traffic_split"):
        router.set_traffic_split(tserving.TrafficSplit(candidate="r1"))
    with pytest.raises(RuntimeError, match="serve_lifecycle"):
        tserving.LifecycleController(router)
    with pytest.raises(ValueError):
        tserving.TrafficSplit(candidate="r1", ab_frac=1.5)


def test_identity_swap_and_rollback_chain_keep_tokens(models, tmp_path):
    """An identity push, its rollback and the commit, on both packages:
    greedy tokens unchanged at every epoch, and the same swap results,
    summary fields, admin section, flight events and swap counters."""
    def run(s, reg):
        eng = s.engine()
        want = _gen(eng, PROMPTS)
        info = eng.swap_weights(s.save(eng, "push"))
        assert info["mode"] == "staged" and not info["pending"]
        assert eng.metrics_summary()["weights_epoch"] == 1
        after_swap = _gen(eng, PROMPTS)
        back = eng.rollback_weights()
        assert eng.metrics_summary()["weights_epoch"] == 2
        after_back = _gen(eng, PROMPTS)
        eng.commit_swap()
        with pytest.raises(s.serving.WeightSwapError, match="no previous"):
            eng.rollback_weights()
        w = eng._admin_status()["weights"]
        assert w["epoch"] == 2 and w["live_manifest"] is None
        assert w["swaps"]["cutover"] == 2 and w["swaps"]["rolled_back"] == 1
        assert after_swap == want and after_back == want
        return want, s.clean([info, back]), s.swap_record(eng, reg)
    j, t = both(models, tmp_path, run)
    assert t == j


@pytest.mark.parametrize("push", ["torn", "missing", "shape", "keys",
                                  "dtype"])
def test_refused_pushes_change_nothing(models, tmp_path, push):
    """Each refused push leaves the epoch, the staged and retained trees
    and the greedy tokens as they were. Except for the dtype push (the
    JAX package, with 64-bit types off, cannot hold the float64 leaf it
    needs), the JAX engine refuses the same push with the same reason,
    summary fields, admin section, flight events and swap counters."""
    match = {"torn": "torn", "missing": "missing", "shape": "shape",
             "keys": "missing", "dtype": "dtype"}[push]

    def run(s, reg):
        eng = s.engine()
        want = _gen(eng, PROMPTS, 4)
        state = {k: np.asarray(v) for k, v in eng.params.items()}
        first = next(iter(state))
        if push == "shape":
            state[first] = np.zeros((3, 3), np.float32)
        elif push == "keys":
            state.pop(first)
            state["not_a_param"] = np.zeros(2, np.float32)
        elif push == "dtype":
            state[first] = state[first].astype(np.float64)
        path = os.path.join(s.root, push)
        if push != "missing":
            path = s.save_arrays(push, state)
        with s.chaos.chaos_scope("serve.swap.torn_manifest@1") \
                if push == "torn" else contextlib.nullcontext():
            with pytest.raises(s.serving.WeightSwapError,
                               match=match) as ei:
                eng.swap_weights(path)
        summ = eng.metrics_summary()
        assert summ["weights_epoch"] == 0
        assert summ["weight_swaps_refused"] == 1
        assert eng._staged is None and eng._previous is None
        assert _gen(eng, PROMPTS, 4) == want
        return s.clean(str(ei.value)), s.swap_record(eng, reg)
    if push == "dtype":
        side = Side("port", models, tmp_path)
        with flag_scope("flight_recorder", True), scoped_registry() as reg:
            run(side, reg)
        return
    j, t = both(models, tmp_path, run)
    assert t == j


def test_armed_but_unused_dispatches_as_flags_off(models, tmp_path):
    """An engine armed for hot swaps that never swaps dispatches as one
    with the flag off (the same counters, no swap series), in the port
    as in the JAX engine."""
    _, tm = models
    with scoped_registry() as reg:
        base = _engine(tm)
        want = _gen(base, PROMPTS)
        base_sum = dict(base._stats)
        assert "serve_swaps_total" not in reg.snapshot()
        assert "serve_weights_epoch" not in reg.snapshot()
    keys = ("decode_dispatches", "prefill_dispatches", "prefill_chunks",
            "tokens_generated")

    def run(s, reg):
        eng = s.engine()
        got = _gen(eng, PROMPTS)
        return got, {k: eng._stats[k] for k in keys}, s.swap_record(eng,
                                                                    reg)
    j, t = both(models, tmp_path, run)
    assert t == j
    assert t[0] == want
    assert t[1] == {k: base_sum[k] for k in keys}
    assert t[2]["events"] == [] and t[2]["metrics"] == {}


def test_swap_mid_decode_splits_requests_by_admission(models, tmp_path):
    """A candidate with DIFFERENT weights is pushed while three requests
    decode: they finish on the old weights, token for token what an
    engine that never swapped gives them; two requests submitted after
    the push are admitted after the cutover and give what an engine
    built on the candidate gives them. The JAX engine, given the same
    candidate at the same step, gives the same tokens, epochs, retired
    trees, stats, flight events and swap counters."""
    def run(s, reg):
        eng = s.engine()
        push = s.save(eng, "cand", 0.02)
        early = [eng.submit(s.Request(p, max_new_tokens=8))
                 for p in PROMPTS]
        eng.step()
        eng.step()
        assert all(st.slot is not None and 2 <= len(st.generated) < 8
                   for st in early)
        resident = [len(st.generated) for st in early]
        info = eng.swap_weights(push)
        assert info["pending"]
        assert eng.metrics_summary()["weights_epoch"] == 0
        late = [eng.submit(s.Request(p, max_new_tokens=6)) for p in LATE]
        eng.step()                      # the cutover, then this step
        cut = (eng.metrics_summary()["weights_epoch"], sorted(eng._retired),
               [st.weights_epoch for st in early])
        eng.run()
        assert all(st.outcome == "completed" for st in early + late)
        st = eng.scheduler.stats
        return dict(
            resident=resident, info=s.clean(info), cut=cut,
            retired_after=sorted(eng._retired),
            early=_seqs(early), late=_seqs(late),
            late_epochs=[x.weights_epoch for x in late],
            stats={k: st[k] for k in ("submitted", "completed", "failed",
                                      "drained")},
            swap=s.swap_record(eng, reg))
    j, t = both(models, tmp_path, run)
    assert t == j
    assert t["cut"] == (1, [0], [0, 0, 0]) and t["retired_after"] == []
    assert t["late_epochs"] == [1, 1]
    assert t["stats"]["submitted"] == t["stats"]["completed"] == 5
    _, tm = models
    old = _engine(tm)
    assert t["early"] == _gen(old, PROMPTS, 8)
    cand = _perturbed(_engine(tm).params, 0.02)
    assert t["late"] == _gen(_engine(_model_with(cand)), LATE, 6)
    assert t["late"] != _gen(old, LATE, 6)


def test_drain_mode_swap_continues_token_exact(models, tmp_path):
    """``mode="drain"`` with two slots resident: the continuations
    resubmit with their callbacks, the client streams equal a
    never-swapped engine's, and the JAX engine gives the same streams,
    swap result, scheduler stats, flight events and swap counters."""
    def run(s, reg):
        eng = s.engine()
        push = s.save(eng, "push")
        streams = [[], []]
        sts = [eng.submit(s.Request(
            p, max_new_tokens=8,
            on_token=lambda r, tok, text, b=b: b.append(int(tok))))
            for p, b in zip(PROMPTS[:2], streams)]
        eng.step()
        eng.step()
        info = eng.swap_weights(push, mode="drain")
        assert info["mode"] == "drain" and info["resubmitted"] == 2
        assert eng.metrics_summary()["weights_epoch"] == 1
        eng.run()
        st = eng.scheduler.stats
        assert st["submitted"] == (st["completed"] + st["expired"]
                                   + st["shed"] + st["cancelled"]
                                   + st["failed"] + st["drained"])
        del sts
        return dict(
            streams=[list(p) + b for p, b in zip(PROMPTS[:2], streams)],
            info=s.clean(info),
            stats={k: st[k] for k in ("submitted", "completed", "drained",
                                      "failed")},
            drain_swaps=eng._swap_stats["drain_swaps"],
            swap=s.swap_record(eng, reg))
    j, t = both(models, tmp_path, run)
    assert t == j
    _, tm = models
    assert t["streams"] == _gen(_engine(tm), PROMPTS[:2], 8)
    assert t["stats"]["drained"] == 2 and t["stats"]["submitted"] == 4
    assert t["drain_swaps"] == 1


def test_auto_mode_reads_the_cards_headroom(models, tmp_path, monkeypatch):
    _, tm = models
    eng = _armed(tm)
    push = _save_manifest(eng, tmp_path / "push")
    assert eng.swap_weights(push)["mode"] == "staged"      # CPU: no stats
    monkeypatch.setattr(tmemory, "device_memory_stats",
                        lambda device=None: {"bytes_limit": 100,
                                             "bytes_in_use": 99})
    assert eng.swap_weights(push)["mode"] == "drain"


def test_shutdown_drops_a_pending_candidate(models, tmp_path):
    _, tm = models
    eng = _armed(tm)
    push = _save_manifest(eng, tmp_path / "push")
    eng.submit(tserving.Request(PROMPTS[0], max_new_tokens=32))
    eng.step()
    assert eng.swap_weights(push)["pending"]
    leaf = weakref.ref(next(iter(eng._staged["params"].values())))
    eng.shutdown()
    assert eng._staged is None and eng._retired == {}
    gc.collect()
    assert leaf() is None


# -- the fleet ------------------------------------------------------------------
SWAP_FLAGS = (("serve_hot_swap", True), ("serve_traffic_split", True))


def _drive(router, n, seed=4):
    spec = tserving.LoadSpec(num_requests=n, rate_rps=400.0,
                             prompt_len_range=(4, 10), max_new_range=(2, 4),
                             vocab_size=256, seed=seed,
                             sampling=tserving.SamplingParams())
    recs = [router.submit(req) for _, req in tserving.build_requests(spec)]
    router.run()
    return recs


def test_controller_promotes_a_good_push_rolling(models, tmp_path):
    _, tm = models
    router = _fleet(tm, flags=SWAP_FLAGS)
    push = _save_manifest(router.replicas["r0"].engine, tmp_path / "push")
    with flag_scope("serve_lifecycle", True):
        ctrl = tserving.LifecycleController(router, tserving.LifecycleConfig(
            bake_window_s=0.0, min_requests=3))
    out = ctrl.begin(push, candidate="r1", split=tserving.TrafficSplit(
        candidate="r1", ab_frac=0.3, shadow_frac=1.0, seed=7))
    assert out["state"] == "baking" and out["epoch"] == 1
    recs = _drive(router, 12)
    assert all(r.outcome == "completed" for r in recs)
    if ctrl.state != "promoted":
        assert ctrl.maybe_decide() == "promoted"
    assert ctrl.summary()["decision"]["rolled"] == ["r0"]
    assert {n: r.engine.metrics_summary()["weights_epoch"]
            for n, r in router.replicas.items()} == {"r0": 1, "r1": 1}
    assert router.summary()["traffic_split"] is None
    with pytest.raises(tserving.WeightSwapError):
        router.replicas["r1"].engine.rollback_weights()
    assert [e["to"] for e in ctrl.timeline] \
        == ["serving", "staging", "baking", "promoted"]


def test_nan_push_is_rolled_back_by_the_controller(models, tmp_path):
    _, tm = models
    inc = str(tmp_path / "incidents")
    with flag_scope("flight_recorder", True), \
            flag_scope("flight_recorder_dir", str(tmp_path)):
        router = _fleet(tm, flags=SWAP_FLAGS)
        base = router.replicas["r0"].engine
        want = _gen(base, PROMPTS, 4)
        push = _save_manifest(base, tmp_path / "push")
        with flag_scope("serve_lifecycle", True):
            ctrl = tserving.LifecycleController(
                router, tserving.LifecycleConfig(
                    bake_window_s=30.0, min_requests=3, incident_dir=inc))
        with chaos.chaos_scope("serve.swap.bad_weights@1"):
            assert ctrl.begin(push, candidate="r1")["state"] == "baking"
        recs = _drive(router, 10)
        assert ctrl.state == "rolled-back"
        assert ctrl.summary()["decision"]["trigger"] == "nonfinite"
        assert all(r.outcome == "completed" for r in recs)
        assert router.summary()["availability_pct"] == 100.0
        assert _gen(base, PROMPTS, 4) == want
        assert _gen(router.replicas["r1"].engine, PROMPTS, 4) == want
        events = [e["event"] for e in tflight.get_flight_recorder().events]
    assert "lifecycle_rollback" in events and "weights_cutover" in events
    bundles = os.listdir(inc)
    assert len(bundles) == 1 and bundles[0].endswith("nonfinite")
    with open(os.path.join(inc, bundles[0], "incident.json")) as f:
        doc = json.load(f)
    assert doc["decision"] == "rolled-back"
    assert doc["arms"]["shadow"]["outcomes"].get("failed", 0) >= 1
    assert "flight.json" in os.listdir(os.path.join(inc, bundles[0]))


def test_refused_and_dying_pushes_abort_to_serving(models, tmp_path):
    _, tm = models
    router = _fleet(tm, flags=SWAP_FLAGS)
    with flag_scope("serve_lifecycle", True):
        ctrl = tserving.LifecycleController(router)
    out = ctrl.begin(str(tmp_path / "nope"), candidate="r1")
    assert out["aborted"] == "refused" and ctrl.state == "serving"
    assert router.summary()["traffic_split"] is None
    push = _save_manifest(router.replicas["r0"].engine, tmp_path / "push")
    with chaos.chaos_scope("serve.swap.replica_die_mid_swap@1"):
        out = ctrl.begin(push, candidate="r1")
        assert chaos.fired()
    assert out["aborted"] == "replica_died" and ctrl.state == "serving"
    assert not router.replicas["r1"].alive
    recs = _drive(router, 4)
    assert all(r.outcome == "completed" and r.replica == "r0"
               for r in recs)


def test_shadow_mirrors_measure_but_never_serve(models, tmp_path):
    _, tm = models
    with scoped_registry() as reg:
        router = _fleet(tm, flags=SWAP_FLAGS)
        cand = router.replicas["r1"].engine
        cand.swap_weights(_save_manifest(cand, tmp_path / "c", 0.05))
        router.set_traffic_split(tserving.TrafficSplit(
            candidate="r1", shadow_frac=1.0, seed=7))
        tokens = []
        recs = [router.submit(tserving.Request(
            p, max_new_tokens=6, on_token=lambda r, t, x: tokens.append(t)))
            for p in PROMPTS]
        router.run()
        s = router.summary()
        snap = reg.snapshot()
    assert all(r.outcome == "completed" for r in recs)
    assert s["shadow_mirrored"] == 3 and s["arm_requests"]["shadow"] == 3
    assert len(tokens) == sum(len(r.tokens) for r in recs)
    assert s["requests_offered"] == 3 and s["availability_pct"] == 100.0
    assert s["shadow_divergence"] >= 1
    assert "serve_shadow_divergence_total" in snap
    arm_events = {tuple(sorted(lb.items())) for lb, _ in
                  snap["serve_arm_requests_total"]["samples"]}
    assert (("arm", "shadow"), ("event", "completed")) in arm_events


def test_ab_arms_route_as_the_loadgen_tags(models):
    _, tm = models
    router = _fleet(tm, flags=SWAP_FLAGS)
    router.set_traffic_split(tserving.TrafficSplit(candidate="r1",
                                                   ab_frac=0.4, seed=11))
    spec = tserving.LoadSpec(num_requests=16, rate_rps=100.0,
                             prompt_len_range=(4, 10), max_new_range=(2, 4),
                             vocab_size=256, seed=2,
                             sampling=tserving.SamplingParams(),
                             ab_split=0.4, split_seed=11)
    schedule = tserving.build_requests(spec)
    tags = {int(r.request_id): r.lifecycle_arm for _, r in schedule}
    recs = [router.submit(req) for _, req in schedule]
    router.run()
    assert {r.outcome for r in recs} == {"completed"}
    assert {r.request_id: r.arm for r in recs} == tags
    assert set(tags.values()) == {"baseline", "candidate"}
    assert all((r.replica == "r1") == (r.arm == "candidate") for r in recs)


def test_three_live_swaps_under_bursty_fleet_load(models, tmp_path):
    _, tm = models
    spec = tserving.LoadSpec(num_requests=36, rate_rps=300.0,
                             prompt_len_range=(4, 10), max_new_range=(3, 6),
                             vocab_size=256, seed=9,
                             sampling=tserving.SamplingParams(),
                             arrival="mmpp", burstiness=3.0,
                             mmpp_switch=0.2)
    router = _fleet(tm, router_kw={"saturation_queue_depth": 12},
                    flags=(("serve_hot_swap", True),))
    push = _save_manifest(router.replicas["r0"].engine, tmp_path / "push")
    schedule = tserving.build_requests(spec)
    quarters = [len(schedule) // 4, len(schedule) // 2,
                3 * len(schedule) // 4]
    swaps, i, t0 = 0, 0, time.perf_counter()
    pending = 0
    while i < len(schedule) or any(r.alive and r.engine.scheduler.has_work
                                   for r in router.replicas.values()):
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            router.submit(schedule[i][1])
            i += 1
        if swaps < len(quarters) and i >= quarters[swaps]:
            for rep in router.replicas.values():
                info = rep.engine.swap_weights(push)
                pending += bool(info["pending"])
                if not info["pending"]:
                    rep.engine.commit_swap()
            swaps += 1
        router.step_all()
    s = router.summary()
    assert swaps == 3 and pending >= 1
    assert {n: r.engine.metrics_summary()["weights_epoch"]
            for n, r in router.replicas.items()} == {"r0": 3, "r1": 3}
    assert s["availability_pct"] >= 99.9
    assert s["duplicate_request_ids"] == 0 and s["requests_in_flight"] == 0
    assert s["requests_offered"] == s["requests_completed"] \
        + s["requests_failed"] + s["requests_rejected"]
