"""The port's fleet router and fleet monitor
(``paddle_tpu_torch.serving.router``, ``paddle_tpu_torch.monitor.fleet``,
``serving.loadgen.run_fleet_open_loop``) against the JAX package on the
CPU.

``gpt_tiny`` engines from one numpy seed (the JAX model's weights carried
into the port by ``models.convert``) sit behind each package's
``FleetRouter``. For a seeded ``LoadSpec`` every request must go to the
same replica with the same affine or balanced decision in both packages
(the affinity key is the blake2b digest of the prompt's first page as
int64 bytes, the fallback the same seeded power-of-two choice). The
port's fleet must give one engine's greedy tokens, and a replica killed
or drained mid-run must lose and duplicate no request id, with every
continuation token-exact against a full-forward rollout. The fleet
monitor's trace merge, target parsing and federated status agree with
the JAX module's on the same inputs.

Tolerances: none, every comparison is exact.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fleet.py``.
"""

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu.core.flags import flag_scope as jflag_scope
from paddle_tpu.monitor import fleet as jfleet
from paddle_tpu.monitor.metrics import MetricsRegistry as JaxRegistry
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_weights
from paddle_tpu_torch.monitor import fleet as tfleet
from paddle_tpu_torch.monitor import lint_exposition, scoped_registry
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.monitor.metrics import MetricsRegistry

WIDE = dict(hidden_size=128, num_heads=2, initializer_range=0.3)
# the JAX tests' engine: 3 slots, 4-token pages, buckets 8 and 16
CFG = dict(max_batch_slots=3, block_size=4, max_context_len=64,
           prefill_buckets=(8, 16), batch_buckets=(1, 2))
REP_PROMPT = [3, 4, 5, 3, 4, 5, 3, 4]
PROMPTS = [REP_PROMPT, [7, 8, 9, 7, 8, 9, 7, 8], [1, 2, 1, 2, 1, 2]]


@pytest.fixture(autouse=True)
def _port_isolation():
    def reset():
        ttrace.set_tracer(None)
        ttrace.reset_trace_stats()
        tfleet.stop_federator()
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


def _fleet(model, n=2, router_kw=None, flags=(), jax_side=False, **kw):
    """N engines behind a router; ``flags`` are in scope while the engines
    are built (they read them once)."""
    serving = jserving if jax_side else tserving
    scope = jflag_scope if jax_side else flag_scope
    extra = {} if jax_side else {"device": "cpu"}
    with contextlib.ExitStack() as stack:
        for name, val in flags:
            stack.enter_context(scope(name, val))
        reps = {f"r{i}": serving.ServingEngine(
            model, serving.ServingConfig(**dict(CFG, **kw)), **extra)
            for i in range(n)}
        return serving.FleetRouter(reps,
                                   serving.RouterConfig(**(router_kw or {})))


def _golden(model, prompt, n):
    """Greedy rollout by full no-cache forwards."""
    seq = np.asarray(prompt, np.int64)
    with torch.no_grad():
        for _ in range(n):
            lg = model(torch.from_numpy(seq[None]))
            seq = np.concatenate([seq, [int(lg[0, -1].argmax())]])
    return seq.tolist()


# -- placement -------------------------------------------------------------------
@pytest.mark.parametrize("n,saturation,seed", [(2, 999, 5), (3, 2, 6),
                                               (4, 1, 7)])
def test_routes_match_jax(models, n, saturation, seed):
    """The same seeded tenanted traffic, submitted before any step: each
    request's replica and its affine or balanced decision are the JAX
    router's."""
    spec = dict(num_requests=24, rate_rps=1e6, prompt_len_range=(4, 10),
                max_new_range=(3, 6), vocab_size=256, seed=seed,
                shared_prefix_len=8, prefix_pool_size=2, prefix_zipf=1.2,
                tenants=4)
    out = []
    for side, model in (("jax", models[0]), ("port", models[1])):
        serving = jserving if side == "jax" else tserving
        router = _fleet(model, n=n, jax_side=side == "jax",
                        router_kw=dict(saturation_queue_depth=saturation,
                                       seed=seed))
        routes = []
        for _, req in serving.build_requests(serving.LoadSpec(
                sampling=serving.SamplingParams(), **spec)):
            before = router._stats["routed_affine"]
            rec = router.submit(req)
            routes.append((rec.replica, "affine"
                           if router._stats["routed_affine"] > before
                           else "balanced"))
        out.append(routes)
        router.shutdown()
    assert out[0] == out[1]
    kinds = {k for _, k in out[1]}
    assert kinds == ({"affine"} if saturation == 999
                     else {"affine", "balanced"})
    assert len({r for r, _ in out[1]}) >= 2


def test_affinity_key_is_the_jax_hash():
    np.testing.assert_equal(
        tserving.FleetRouter._hash(np.arange(4, dtype=np.int64).tobytes()),
        jserving.FleetRouter._hash(np.arange(4, dtype=np.int64).tobytes()))


def test_fleet_greedy_tokens_are_one_engines(models):
    _, tm = models
    eng = tserving.ServingEngine(tm, tserving.ServingConfig(**CFG),
                                 device="cpu")
    want = [o.tolist() for o in eng.generate(PROMPTS, max_new_tokens=6)]
    eng.shutdown()
    router = _fleet(tm, n=3, flags=(("serve_prefix_cache", True),))
    got = [o.tolist() for o in router.generate(PROMPTS + PROMPTS[:1],
                                               max_new_tokens=6)]
    router.shutdown()
    assert got == want + want[:1]


def test_p2c_fallback_and_unready_replicas(models):
    _, tm = models
    router = _fleet(tm, n=2, router_kw=dict(saturation_queue_depth=0))
    recs = [router.submit(tserving.Request(REP_PROMPT, max_new_tokens=2))
            for _ in range(8)]
    s = router.summary()
    assert s["routed_balanced"] == 8 and s["routed_affine"] == 0
    assert len({r.replica for r in recs}) == 2
    router.run()
    assert all(r.outcome == "completed" for r in recs)
    router.shutdown()
    router = _fleet(tm, n=3)
    router.kill_replica("r0")
    router.drain_replica("r1")
    recs = [router.submit(tserving.Request([50 + 3 * i] * 4,
                                           max_new_tokens=2))
            for i in range(6)]
    assert {r.replica for r in recs} == {"r2"}
    router.run()
    assert all(r.outcome == "completed" for r in recs)
    router.shutdown()


def test_router_rejects_mismatched_block_sizes(models):
    _, tm = models
    a = tserving.ServingEngine(tm, tserving.ServingConfig(**CFG),
                               device="cpu")
    b = tserving.ServingEngine(
        tm, tserving.ServingConfig(**dict(CFG, block_size=8)), device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        tserving.FleetRouter({"a": a, "b": b})


# -- migration -------------------------------------------------------------------
def test_kill_replica_mid_decode_token_exact(models):
    _, tm = models
    oracle = [_golden(tm, p, 8) for p in PROMPTS]
    router = _fleet(tm, n=2)
    recs = [router.submit(tserving.Request(p, max_new_tokens=8))
            for p in PROMPTS]
    for _ in range(3):
        router.step_all()
    victim = next(r.replica for r in recs if not r.done)
    streamed = {r.request_id: list(r.tokens) for r in recs}
    moved = router.kill_replica(victim)
    assert moved >= 1
    router.run()
    assert [r.prompt + r.tokens for r in recs] == oracle
    for r in recs:
        assert r.tokens[:len(streamed[r.request_id])] \
            == streamed[r.request_id]
    s = router.summary()
    assert s["migrated_death"] == moved
    assert s["duplicate_request_ids"] == 0
    assert s["requests_offered"] == s["requests_completed"] == len(PROMPTS)
    assert s["availability_pct"] == 100.0
    router.shutdown()


def test_kill_replica_mid_chunk_prefill_token_exact(models):
    _, tm = models
    router = _fleet(tm, n=2, flags=(("serve_prefill_chunk", 4),))
    prompt = list(range(2, 14))
    rec = router.submit(tserving.Request(prompt, max_new_tokens=6))
    router.step_all()
    assert router.replicas[rec.replica].engine._stats["prefill_chunks"] >= 1
    assert not rec.done and rec.tokens == []
    router.kill_replica(rec.replica)
    router.run()
    assert rec.outcome == "completed"
    assert rec.prompt + rec.tokens == _golden(tm, prompt, 6)
    assert router.summary()["migrated_death"] == 1
    router.shutdown()


def test_drain_replica_migrates_and_keeps_the_trace(models, tmp_path):
    _, tm = models
    with flag_scope("trace", True), flag_scope("trace_sample", 1.0):
        router = _fleet(tm, n=2, router_kw=dict(drain_dir=str(tmp_path)))
        rec = router.submit(tserving.Request(REP_PROMPT, max_new_tokens=8))
        for _ in range(3):
            router.step_all()
        assert 0 < len(rec.tokens) < 8
        tid, first_parent = rec.trace_id, rec.trace_parent
        report = router.drain_replica(rec.replica, budget_s=0.0)
        assert report["snapshotted"] == 1 and report["migrated"] == 1
        assert rec.trace_parent != first_parent
        router.run()
        router.shutdown()
        docs = tfleet.merge_fleet_traces(
            ttrace.get_tracer().snapshot(include_live=True))
    assert rec.outcome == "completed" and rec.hops == 1
    assert rec.prompt + rec.tokens == _golden(tm, REP_PROMPT, 8)
    assert rec.trace_id == tid
    s = router.summary()
    assert s["migrated_drain"] == 1 and s["availability_pct"] == 100.0
    doc = next(d for d in docs if d["trace_id"] == tid)
    assert doc["name"] == "fleet.request" and doc["merged_from"] == 3
    hop = next(sp for sp in doc["spans"] if sp["name"] == "migrate")
    assert hop["attrs"]["reason"] == "drain"
    serves = [sp for sp in doc["spans"] if sp["name"] == "serve.request"]
    assert len(serves) == 2
    assert hop["span_id"] in {sp["parent_id"] for sp in serves}


def test_threaded_fleet_serves_and_stops(models):
    _, tm = models
    router = _fleet(tm, n=2)
    router.start()
    try:
        recs = [router.submit(tserving.Request(p, max_new_tokens=4))
                for p in PROMPTS]
        deadline = time.monotonic() + 60.0
        while not all(r.done for r in recs):
            assert time.monotonic() < deadline, "threaded fleet stalled"
            time.sleep(0.01)
            router._sweep()
    finally:
        router.stop()
    assert all(r.outcome == "completed" for r in recs)
    assert not any(rep.last_error for rep in router.replicas.values())
    assert [r.prompt + r.tokens for r in recs] \
        == [_golden(tm, p, 4) for p in PROMPTS]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ptpu-replica-")]
    router.shutdown()


def test_fleet_open_loop_keeps_the_single_engines_prefix_hits(models):
    _, tm = models
    spec = tserving.LoadSpec(
        num_requests=24, rate_rps=1e6, prompt_len_range=(4, 10),
        max_new_range=(3, 6), vocab_size=256, seed=5,
        sampling=tserving.SamplingParams(), shared_prefix_len=8,
        prefix_pool_size=2, prefix_zipf=1.2, tenants=4)
    hits = {}
    for n in (1, 2):
        router = _fleet(tm, n=n,
                        router_kw=dict(saturation_queue_depth=999),
                        flags=(("serve_prefix_cache", True),))
        s = tserving.run_fleet_open_loop(router, spec)
        router.shutdown()
        assert s["requests_completed"] == 24
        assert s["requests_rejected_router"] == 0
        assert s["aggregate_tokens_per_sec"] > 0
        hits[n] = s["fleet_prefix_hit_pct"]
    assert hits[1] > 0 and abs(hits[2] - hits[1]) <= 5.0


# -- fleet monitor ---------------------------------------------------------------
def _doc(trace_id, ctx, process, spans, parent_ctx=None, **kw):
    d = {"trace_id": trace_id, "name": spans[0]["name"], "ctx": ctx,
         "process": process, "head_sampled": kw.get("head_sampled", True),
         "anomaly": kw.get("anomaly"), "finished": kw.get("finished", True),
         "spans": spans}
    if parent_ctx is not None:
        d["parent_ctx"] = parent_ctx
    return d


def _span(span_id, parent_id, name):
    return {"span_id": span_id, "parent_id": parent_id, "name": name,
            "t0": 0.0, "t1": 1.0, "attrs": {}}


MERGE_CASES = {
    "single": [_doc("t1", "a.1", None, [_span(0, None, "serve.request")])],
    "joined": [_doc("t1", "b.9", "r0", [_span(0, None, "serve.request")],
                    parent_ctx="a.1/1", finished=False, anomaly="expired"),
               _doc("t1", "a.1", "router", [_span(0, None, "fleet.request"),
                                            _span(1, 0, "route")])],
    "orphan": [_doc("t1", "a.1", "r0", [_span(0, None, "serve.request")],
                    parent_ctx="gone.7/3"),
               _doc("t1", "b.2", "r1", [_span(0, None, "serve.request")],
                    parent_ctx="a.1/0"),
               _doc("t2", "c.3", "r1", [_span(0, None, "serve.request")])],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_fleet_traces_matches_jax(case):
    docs = MERGE_CASES[case]
    want = jfleet.merge_fleet_traces(json.loads(json.dumps(docs)))
    got = tfleet.merge_fleet_traces(json.loads(json.dumps(docs)))
    assert got == want


def test_parse_targets_matches_jax():
    spec = "a=http://h:1, http://h2:2/ ,b = http://h3:3/"
    key = [(t.name, t.url) for t in jfleet.parse_targets(spec)]
    assert [(t.name, t.url) for t in tfleet.parse_targets(spec)] == key
    assert tfleet.parse_targets("") == []


def _fill(reg):
    reg.counter("serve_requests_total", "x").inc(10, event="completed")
    reg.counter("serve_requests_total", "x").inc(2, event="failed")
    reg.gauge("serve_queue_depth", "x").set(3)
    reg.counter("serve_prefix_hits_total", "x").inc(3)
    reg.counter("serve_prefix_misses_total", "x").inc(1)
    reg.counter("serve_tenant_requests_total", "x").inc(
        4, tenant="t0", event="completed")


def test_federated_status_matches_jax():
    """Both federators over a local registry target with the same
    samples and clock: the same scrape summary, federated samples and
    ``/statusz`` fleet document, a lint-clean page, and a rebuild (not
    an accumulation) on the next scrape."""
    out = []
    for fl, Reg in ((jfleet, JaxRegistry), (tfleet, MetricsRegistry)):
        reg = Reg()
        _fill(reg)
        fed = fl.FleetFederator(
            [fl.FleetTarget("local", fetch_metrics=reg.to_prometheus,
                            fetch_ready=lambda: True),
             fl.FleetTarget("gone", fetch_metrics=lambda: 1 / 0)],
            fl.FederatorConfig(slo_availability=0.9,
                               slo_windows=(60.0, 600.0)),
            clock=lambda: 1000.0)
        s = fed.scrape_once()
        fed.scrape_once()
        status = fed._fleet_status()
        samples = sorted((m, tuple(sorted(lb.items())), v)
                         for m in ("serve_requests_total", "fleet_replicas",
                                   "fleet_scrapes_total")
                         for lb, v in fed.registry.get(m).samples())
        out.append((s["targets_scraped"], s["alerts"], samples,
                    json.loads(json.dumps(status, sort_keys=True)),
                    fed._quorum_check()))
        if fl is tfleet:
            assert lint_exposition(fed.registry.to_prometheus()) == []
    assert out[0] == out[1]
    assert out[1][3]["targets"]["local"]["prefix_hit_pct"] == 75.0


def test_fleet_incident_bundle_on_an_slo_burn(models, tmp_path):
    """A deadline blowout over a 2-replica fleet spends the fleet SLO's
    budget: the first scrape captures ONE bundle (rate-limited after),
    with the federated page, the status, the flight doc and the merged
    trace."""
    _, tm = models
    clk = [1000.0]
    with scoped_registry(), flag_scope("trace", True), \
            flag_scope("trace_sample", 1.0):
        router = _fleet(tm, n=2)
        fed = tfleet.FleetFederator(
            [tfleet.local_registry_target("local")],
            tfleet.FederatorConfig(slo_availability=0.9,
                                   slo_windows=(60.0, 600.0),
                                   alert_pairs=((600.0, 60.0, 1.0),),
                                   incident_dir=str(tmp_path)),
            router=router, clock=lambda: clk[0])
        recs = [router.submit(tserving.Request(p, max_new_tokens=4,
                                               tenant=f"t{i % 2}"))
                for i, p in enumerate(PROMPTS)]
        doomed = router.submit(tserving.Request(REP_PROMPT,
                                                max_new_tokens=4,
                                                deadline_s=1e-6))
        time.sleep(0.01)
        router.run()
        assert doomed.outcome == "expired"
        assert all(r.outcome == "completed" for r in recs)
        s1 = fed.scrape_once()
        clk[0] += 10.0
        s2 = fed.scrape_once()
        tenants = fed._fleet_status()["tenants"]
        router.shutdown()
    assert s1["alerts"] and s1["incident"] is not None
    assert s2["incident"] is None
    assert set(tenants) >= {"t0", "t1"}
    bundles = [d for d in os.listdir(tmp_path) if d.startswith("incident_")]
    assert len(bundles) == 1 and bundles[0].endswith("slo_burn")
    assert {"incident.json", "statusz.json", "metrics.prom", "flight.json",
            "trace_perfetto.json"} <= set(os.listdir(tmp_path / bundles[0]))


def test_fleet_plane_off_by_default_and_gauges(models):
    _, tm = models
    with scoped_registry() as reg:
        router = _fleet(tm, n=2, flags=(("serve_prefix_cache", True),))
        router.generate([REP_PROMPT], max_new_tokens=3)
        router.kill_replica("r1")
        router.summary()
        snap = reg.snapshot()
        router.shutdown()
    assert tfleet.get_federator() is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith(tfleet.SCRAPE_THREAD_PREFIX)]
    assert ttrace.TRACE_STATS["spans_allocated"] == 0
    states = {tuple(sorted(lb.items())): v for lb, v in
              snap["serve_router_replicas"]["samples"]}
    assert states[(("state", "alive"),)] == 1
    assert states[(("state", "ready"),)] == 1
    with flag_scope("fleet_monitor_port", -1):
        fed = tfleet.maybe_start_from_flags()
        assert fed is not None and fed.url and fed.running
    tfleet.stop_federator()
    assert tfleet.get_federator() is None
