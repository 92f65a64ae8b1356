"""The port's monitor plane (``paddle_tpu_torch.monitor``, ``.testing``,
``.profiler``, ``.cost_model``) against the JAX package on the CPU.

Each case feeds both packages the same inputs: registry operations give
the same Prometheus text and JSONL records; one chaos spec and seed fire
on the same occurrences; SLO burn and the Perfetto export agree under an
injected clock; a poisoned request fails alone in both engines with the
same reason, metrics and trace outcome; the ``TrainStep`` watchdog names
the same offender and skips the same step. With every flag off the hot
paths write nothing, record nothing and trace nothing.

Tolerances: losses of steps taken after a skipped step, 1e-4 absolute
(f32 sums in other orders, as ``test_torch_bert.py``); per-layer health
norms, 1e-5 relative; everything else exact.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_monitor.py``.
"""

import json
import re
import subprocess
import sys
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmon
from paddle_tpu.core.flags import flag_scope as jflag_scope
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.cost_model import CostModel
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertForMaskedLM, GPTForPretraining,
                                     bert_tiny, gpt_tiny, load_jax_weights)
from paddle_tpu_torch.monitor import flight_recorder as tflight
from paddle_tpu_torch.monitor import goodput as tgoodput
from paddle_tpu_torch.monitor import memory as tmemory
from paddle_tpu_torch.monitor import server as tserver
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (Request, ServingConfig,
                                      ServingEngine)
from paddle_tpu_torch.testing import chaos as tchaos

REPO = Path(__file__).resolve().parents[1]
# bench.py --serve --quick, on the tiny GPT with the flash kernels' D=64
QUICK = dict(max_batch_slots=4, block_size=8, max_context_len=128,
             prefill_buckets=(16, 32), batch_buckets=(1, 2, 4))
WIDE = dict(hidden_size=128, num_heads=2, initializer_range=0.3)
LOSS_TOL = 1e-4
# per-layer health norms of step 4 against JAX's, relative: f32 sums of
# squares in another order, an update ratio the quotient of two (5.9e-07
# read on the CPU)
HEALTH_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_monitor_isolation():
    """The port's process-global monitor state, reset around each case
    (the conftest resets the JAX package's)."""
    def reset():
        tchaos.reset()
        ttrace.set_tracer(None)
        ttrace.reset_trace_stats()
        tgoodput.reset()
        tflight.set_flight_recorder(None)
        tserver.stop_server()
        tmemory._PROGRAMS.clear()
    reset()
    yield
    reset()


# -- the registry -----------------------------------------------------------------
def _registry_ops(mon):
    reg = mon.MetricsRegistry()
    reg.counter("serve_requests_total", "requests by event").inc(
        event="submitted")
    reg.counter("serve_requests_total").inc(3, event="completed")
    reg.gauge("serve_queue_depth", "waiting").set(7)
    reg.gauge("serve_queue_depth").dec(2)
    h = reg.histogram("serve_ttft_seconds", "ttft \\ with \"quotes\"\n")
    for i, v in enumerate((0.0004, 0.003, 0.07, 2.5, 11.0)):
        h.observe(v, exemplar=f"t-{i}")
    reg.histogram("serve_decode_occupancy", "occupancy",
                  buckets=(1, 2, 3, 4)).observe(3, bucket="b4_s16")
    return reg


def _no_ts(d):
    """A record without its timestamps (the line's and the exemplars')."""
    if isinstance(d, dict):
        return {k: _no_ts(v) for k, v in d.items() if k != "ts"}
    return d


def test_registry_text_and_jsonl_equal(tmp_path):
    """The same operations give byte-equal Prometheus text, with and
    without exemplars, and equal JSONL records, apart from timestamps."""
    jreg, treg = _registry_ops(jmon), _registry_ops(tmon)
    assert treg.to_prometheus() == jreg.to_prometheus()
    # an exemplar ends with the wall time of its observation
    ex_ts = re.compile(r"( # \{[^}]*\} \S+) \S+$", re.M)
    texts = [ex_ts.sub(r"\1", reg.to_prometheus(exemplars=True))
             for reg in (jreg, treg)]
    assert texts[0] == texts[1] and 'trace_id="t-4"' in texts[1]
    assert tmon.lint_exposition(treg.to_prometheus()) == []
    recs = []
    for mon, reg in ((jmon, jreg), (tmon, treg)):
        path = str(tmp_path / f"{mon.__name__}.jsonl")
        reg.dump_jsonl(path, extra={"tag": "x"})
        recs.append([_no_ts(r) for r in mon.load_jsonl(path)])
    assert recs[0] == recs[1] and len(recs[0]) == 5


# -- chaos -----------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "grad.nonfinite@7", "serve.request.poison:0.3",
    "serve.detok.raise:0.05*4,serve.pages.exhaust@1000"])
def test_chaos_fires_on_the_same_occurrences(spec):
    sites = sorted({e.split("@")[0].split(":")[0] for e in spec.split(",")})
    fired = []
    for ch in (jchaos, tchaos):
        ch.configure(spec, seed=11)
        hits = [(s, n) for s in sites for n in range(1, 1001)
                if ch.probe(s)]
        assert hits == ch.fired()
        fired.append(hits)
        ch.reset()
    assert fired[0] == fired[1] and fired[0]
    assert sorted(tchaos.SITES) == sorted(jchaos.SITES)


# -- SLO burn and the Perfetto export --------------------------------------------------
def test_slo_burn_equal_under_an_injected_clock():
    snaps = []
    for mon in (jmon, tmon):
        t = [1000.0]
        slo = mon.SLOTracker("serve_availability", 0.99,
                             windows=(60.0, 300.0), clock=lambda: t[0])
        reg = mon.MetricsRegistry()
        for i in range(400):
            t[0] += 1.5
            slo.record(good=1 if i % 37 else 0, bad=0 if i % 37 else 1)
            if i % 50 == 0:
                slo.publish(registry=reg)
        snaps.append((slo.snapshot(), reg.to_prometheus()))
    assert snaps[0] == snaps[1]


def _traces(mon):
    tr = mon.Tracer(clock=lambda: 0.0, seed=0)
    for i in range(3):
        t = tr.start_trace("serve.request", trace_id=f"req-{i}",
                           sample=i != 1, t=10.0 * i, request_id=i)
        q = t.start_span("queued", t=10.0 * i)
        t.end_span(q, t=10.0 * i + 0.5)
        a = t.start_span("admitted", t=10.0 * i + 0.5, slot=i)
        t.end_span(t.start_span("prefill", parent=a, t=10.0 * i + 0.6),
                   t=10.0 * i + 0.9)
        if i == 1:
            t.mark_anomaly("chaos", chaos_site="serve.request.poison")
        t.end_span(a, t=10.0 * i + 2.0)
        tr.finish_trace(t, t=10.0 * i + 2.0)
    return tr.snapshot()


def test_perfetto_export_equal_under_an_injected_clock(tmp_path):
    docs = []
    for mon, trace_mod in ((jmon, jmon.trace), (tmon, ttrace)):
        snap = _traces(mon)
        path = trace_mod.export_perfetto(
            str(tmp_path / f"{mon.__name__}.json"), snap,
            include_host_timeline=False)
        with open(path) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    names = {e["args"]["name"] for e in docs[1]["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "serve.request req-1 [ANOMALY:chaos]" in names


# -- the engines -------------------------------------------------------------------
@pytest.fixture(scope="module")
def wide():
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**WIDE))
    jm.eval()
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jm, load_jax_weights(GPTForPretraining(gpt_tiny(**WIDE),
                                                  device="cpu"), named)


def _specs(n=6):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, (int(rng.randint(8, 25)),)),
             int(rng.randint(4, 13))) for _ in range(n)]


def _request_outcomes(reg):
    return {lab["event"]: v for lab, v in
            reg.get("serve_requests_total").samples()}


def test_poisoned_request_fails_alone_in_both_engines(wide):
    """``serve.request.poison@2``: the second request fails with the same
    reason in both engines, the others give equal greedy tokens, the
    request counters agree by event, and both traces end with the same
    outcomes and anomaly kinds (the poisoned one kept by the tail rule
    at a head rate of 0)."""
    from paddle_tpu.serving import (Request as JaxRequest,
                                    ServingConfig as JaxServingConfig,
                                    ServingEngine as JaxServingEngine)
    jm, pm = wide
    specs = _specs()
    runs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            scope, mon, ch = jflag_scope, jmon, jchaos
        else:
            scope, mon, ch = flag_scope, tmon, tchaos
        with scope("trace", True), scope("trace_sample", 0.0), \
                mon.scoped_registry() as reg:
            ch.configure("serve.request.poison@2", seed=0)
            if pkg == "jax":
                mon.trace.get_tracer().reset()
                eng = JaxServingEngine(jm, JaxServingConfig(**QUICK))
                sts = [eng.submit(JaxRequest(p, max_new_tokens=n))
                       for p, n in specs]
            else:
                eng = ServingEngine(pm, ServingConfig(**QUICK),
                                    device="cpu")
                sts = [eng.submit(Request(p, max_new_tokens=n))
                       for p, n in specs]
            eng.run()
            kept = mon.trace.get_tracer().snapshot()
            ttft = reg.get("serve_ttft_seconds").count()
            runs.append((sts, _request_outcomes(reg), kept, ttft,
                         dict(eng.scheduler.stats)))
            ch.reset()
    (js, jcount, jkept, jttft, jstats), (ts, tcount, tkept, tttft, tstats) \
        = runs
    assert [s.outcome for s in ts] == [s.outcome for s in js]
    assert [s.failure for s in ts] == [s.failure for s in js]
    assert ts[1].outcome == "failed" and "non-finite" in ts[1].failure
    assert sum(s.outcome == "failed" for s in ts) == 1
    for a, b in zip(js, ts):
        assert b.generated == a.generated
    assert tcount == jcount == {"submitted": 6.0, "completed": 5.0,
                                "failed": 1.0}
    assert tcount["completed"] == tstats["completed"]
    assert tcount["failed"] == tstats["failed"]
    assert tttft == jttft == 5

    def kinds(snap):
        return sorted((d["anomaly"], d["spans"][0]["attrs"].get("outcome"))
                      for d in snap)
    assert kinds(tkept) == kinds(jkept) == [("chaos", "failed")]


def test_pages_exhaust_preempts_as_in_jax(wide):
    """``serve.pages.exhaust:0.3``: the injected dry pool defers the same
    admissions and recompute-preempts the same requests in both engines
    (the same probes fire), and greedy tokens stay equal."""
    from paddle_tpu.serving import (Request as JaxRequest,
                                    ServingConfig as JaxServingConfig,
                                    ServingEngine as JaxServingEngine)
    jm, pm = wide
    specs = _specs()
    out = []
    for ch in (jchaos, tchaos):
        ch.configure("serve.pages.exhaust:0.3", seed=3)
        if ch is jchaos:
            eng = JaxServingEngine(jm, JaxServingConfig(**QUICK))
            sts = [eng.submit(JaxRequest(p, max_new_tokens=n))
                   for p, n in specs]
        else:
            eng = ServingEngine(pm, ServingConfig(**QUICK), device="cpu")
            sts = [eng.submit(Request(p, max_new_tokens=n))
                   for p, n in specs]
        eng.run()
        out.append((ch.fired(), eng.scheduler.stats["preemptions"],
                    [st.generated for st in sts]))
        ch.reset()
    assert out[1][0] == out[0][0] and out[1][1] == out[0][1] > 0
    assert out[1][2] == out[0][2]


def test_admin_server_serves_the_port_engine(wide):
    """FLAGS_monitor_port=-1 (an ephemeral 127.0.0.1 port): the engine
    registers /readyz and /statusz; /metrics passes the exposition lint."""
    _, pm = wide
    with flag_scope("monitor_port", -1), tmon.scoped_registry():
        eng = ServingEngine(pm, ServingConfig(**QUICK), device="cpu")
        for p, n in _specs(3):
            eng.submit(Request(p, max_new_tokens=n))
        eng.run()
        srv = tserver.get_server()
        assert srv is not None and srv.host == "127.0.0.1"
        base = f"http://127.0.0.1:{srv.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read().decode()
        code, text = get("/metrics")
        assert code == 200 and "serve_requests_total" in text
        assert tmon.lint_exposition(text) == []
        assert get("/healthz")[0] == 200
        code, ready = get("/readyz")
        assert code == 200 and json.loads(ready)["ready"]
        code, status = get("/statusz")
        sec = json.loads(status)["sections"][f"serving_engine_{id(eng)}"]
        assert sec["scheduler"]["completed"] == 3
        assert "torch_version" in json.loads(status)["fingerprint"]
        eng.shutdown()


# -- TrainStep --------------------------------------------------------------------
def _bert_batch(vocab=256, B=2, S=32, M=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, S * 3 // 4:] = 0
    pos = np.stack([rng.choice(np.arange(1, S * 3 // 4), M, replace=False)
                    for _ in range(B)]).astype(np.int64)
    return [ids, np.zeros((B, S), np.int64), mask, pos,
            rng.integers(5, vocab, (B, M)).astype(np.int64),
            np.ones((B, M), np.float32)]


def _bert_pair(**step_kw):
    """The JAX bert_tiny (dropout 0) from ``paddle.seed(0)``, the port's
    with its weights, and a TrainStep of each."""
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    paddle.seed(0)
    jm = jbert.BertForMaskedLM(jbert.bert_tiny())
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_weights(BertForMaskedLM(bert_tiny(), device="cpu"), named)

    def loss(layer, ids, tt, mask, pos, labels, w):
        return layer.loss(layer(ids, tt, mask, pos), labels, w)
    jstep = JaxTrainStep(jm, loss, JaxAdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01),
        **step_kw)
    tstep = TrainStep(pm, loss, AdamW(1e-3, parameters=pm.parameters(),
                                      weight_decay=0.01), **step_kw)
    return jstep, jm, tstep, pm


def _checksum(step):
    return ([p.detach().clone() for p in step.layer.parameters()],
            [s.clone() for slots in step.optimizer._accumulators.values()
             for s in slots], step.step_count)


def _same_state(a, b):
    return a[2] == b[2] and all(torch.equal(x, y)
                                for x, y in zip(a[0] + a[1], b[0] + b[1]))


def test_planted_nan_weight_names_the_same_offender(tmp_path):
    jstep, jm, tstep, pm = _bert_pair(check_numerics=True)
    name = "bert.encoder.layers.1.linear1.weight"
    dict(pm.named_parameters())[name].data[3, 5] = float("nan")
    jw = jstep.params[name]
    jstep.params[name] = jw.at[3, 5].set(float("nan"))
    batch = _bert_batch()
    errs = []
    for step, scope, mon in ((jstep, jflag_scope, jmon),
                             (tstep, flag_scope, tmon)):
        with scope("flight_recorder_dir", str(tmp_path)), \
                mon.scoped_registry() as reg, \
                pytest.raises(Exception) as ei:
            step(*batch)
        assert type(ei.value).__name__ == "NonFiniteError"
        assert reg.get("numerics_nonfinite_total").value(
            what="train_step") == 1
        errs.append(ei.value)
    assert errs[1].offender == errs[0].offender
    assert errs[1].step == errs[0].step == 1
    assert str(errs[1]).split(" (TrainStep")[0] == \
        str(errs[0]).split(" (TrainStep")[0]


def test_skipped_step_keeps_state_and_later_losses_match_jax():
    """``skip_nonfinite_budget=1`` and ``grad.nonfinite@3``: the third
    call is skipped in both (the port leaves every parameter, slot and
    ``step_count`` bit-identical), and the losses of the steps after it
    agree with JAX's."""
    jstep, _, tstep, _ = _bert_pair(skip_nonfinite_budget=1)
    batch = _bert_batch()
    losses = []
    for step, ch, mon in ((jstep, jchaos, jmon), (tstep, tchaos, tmon)):
        ch.configure("grad.nonfinite@3")
        out = []
        with mon.scoped_registry() as reg, warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for i in range(6):
                before = _checksum(step) if step is tstep and i == 2 \
                    else None
                out.append(float(step(*batch)))
                if before is not None:
                    assert _same_state(before, _checksum(step))
            assert reg.get("nonfinite_skips_total").value() == 1
        assert step.step_count == 5
        assert step.stats()["nonfinite_skips"] == 1
        ch.reset()
        losses.append(out)
    assert np.isnan(losses[0][2]) and np.isnan(losses[1][2])
    np.testing.assert_allclose(losses[1][3:], losses[0][3:], atol=LOSS_TOL,
                               rtol=0)


def test_exhausted_budget_raises_with_the_state_rolled_back(tmp_path):
    _, _, tstep, _ = _bert_pair(skip_nonfinite_budget=1)
    batch = _bert_batch()
    tstep(*batch)
    tchaos.configure("grad.nonfinite:1.0")
    before = _checksum(tstep)
    with flag_scope("flight_recorder_dir", str(tmp_path)), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tstep(*batch)                            # skipped, within budget
        with pytest.raises(tmon.NonFiniteError, match="exhausted"):
            tstep(*batch)
    assert _same_state(before, _checksum(tstep))
    assert all(p.grad is None for p in tstep.layer.parameters())
    assert list(tmp_path.glob("flight_recorder_*.json"))


def test_health_goodput_and_attribution_on_the_cpu():
    """FLAGS_train_health_every, FLAGS_train_goodput and FLAGS_monitor:
    every layer's grad norm finite, JAX's layer keys and the three norms
    of step 4 within HEALTH_RTOL of JAX's, the ledger's buckets summing
    to its elapsed time, the first step counted."""
    jstep, _, tstep, _ = _bert_pair()
    batch = _bert_batch()
    keys = []
    for step, scope, mon in ((jstep, jflag_scope, jmon),
                             (tstep, flag_scope, tmon)):
        with scope("train_health_every", 2), scope("monitor", True), \
                scope("train_goodput", True), mon.scoped_registry() as reg:
            for _ in range(4):
                step(*batch)
            health = {name: {lab["layer"]: v for lab, v in
                             reg.get(name).samples()}
                      for name in ("train_layer_grad_norm",
                                   "train_layer_param_norm",
                                   "train_layer_update_ratio")}
            assert all(np.isfinite(v) for v in
                       health["train_layer_grad_norm"].values())
            keys.append(health)
            st = step.stats()
            snap = st["goodput"]
            assert abs(sum(snap["buckets"].values()) - snap["elapsed_s"]) \
                < 1e-6
            assert reg.get("train_step_steps_total").value(kind="step") == 4
    for name, ref in keys[0].items():
        got = keys[1][name]
        assert sorted(got) == sorted(ref)
        for layer, v in ref.items():
            assert got[layer] == pytest.approx(v, rel=HEALTH_RTOL), \
                (name, layer)
    prog = tstep.stats()["programs"]["step"]
    assert prog["flops"] > 0 and prog["bytes_accessed"] > 0


# -- zero overhead with every flag off --------------------------------------------------
def test_flags_off_write_record_and_trace_nothing(wide):
    """The JAX pin (tests/test_monitor.py:119) for the port: TrainStep,
    the DataLoader and LoRA make no registry writes, the flight recorder
    records nothing, no span is allocated, chaos is one cached boolean,
    no goodput ledger exists."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.serving.lora import LoRAManager
    _, _, tstep, _ = _bert_pair()
    batch = _bert_batch()
    with tmon.scoped_registry() as reg:
        for _ in range(3):
            tstep(*batch)
        loader = tio.DataLoader(tio.TensorDataset(
            [np.arange(8, dtype=np.float32).reshape(8, 1)]),
            batch_size=2, places="cpu")
        assert len(list(loader)) == 4
        lora = LoRAManager(2, 16, 48, max_adapters=2, rank=2, device="cpu")
        lora.load_adapter("a", weights=(np.zeros((2, 2, 16), np.float32),
                                        np.zeros((2, 2, 48), np.float32)))
        lora.unload_adapter("a")
        assert reg.write_count == 0 and reg.names() == []
    assert tflight.get_flight_recorder().record_count == 0
    assert ttrace.TRACE_STATS["spans_allocated"] == 0
    assert tgoodput.GOODPUT_STATS["ledgers_allocated"] == 0
    assert tchaos.active() is False
    assert tserver.get_server() is None


# -- the profiler, the cost model and the memory census on the CPU ---------------------
def test_cost_model_counts_kernels_once():
    """A wrapper reports its kernel's work and runs its plain version out
    of FlopCounterMode's sight: the flash forward with dropout counts 4 D
    a causal pair, and no torch FLOP of its plain einsums."""
    from paddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_fwd
    B, S, H, D = 2, 64, 2, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, H, D, generator=g) for _ in range(3))
    cost = CostModel().attribute(lambda: flash_attention_fwd(
        q, k, v, causal=True, dropout_rate=0.1, seed_words=(1, 2)))
    pairs = B * H * S * (S + 1) // 2
    assert cost["kernels"] == {"flash_attention_fwd": {
        "calls": 1, "flops": 4.0 * D * pairs,
        "bytes": 4.0 * B * S * H * D * 4}}
    assert cost["torch_flops"] == 0
    assert cost["flops"] == 4.0 * D * pairs
    assert kernels.costing() is False


def test_profiler_window_and_census(tmp_path):
    _, _, tstep, _ = _bert_pair()
    batch = _bert_batch()
    out = tmp_path / "trace"
    prof = tprof.Profiler(scheduler=(1, 3),
                          on_trace_ready=tprof.export_chrome_tracing(
                              str(out)))
    prof.start()
    with flag_scope("monitor", True), tmon.scoped_registry():
        for _ in range(4):
            tstep(*batch)
            prof.step()
    prof.stop()
    assert prof.windows == 1
    doc = json.loads((out / "host_chrome_trace_1.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert "TrainStep.step" in names and "aten::mm" in names
    census = tmon.live_buffer_census(tstep)
    n = sum(p.numel() * 4 for p in tstep.layer.parameters())
    assert census["params"]["bytes"] == n
    assert census["opt_state"]["bytes"] == 2 * n
    assert "live buffers" in tmon.memory_summary(tstep)


def test_memory_preflight_refuses_work_over_budget(wide):
    """FLAGS_memory_preflight with an explicit 1 MiB budget: the engine
    (its parameter copy and pools) and the TrainStep (parameters,
    gradients, slots) are refused before their first dispatch; 'warn'
    warns and builds."""
    _, pm = wide
    with flag_scope("memory_preflight", "raise"), \
            flag_scope("memory_preflight_limit_mb", 1), \
            tmon.scoped_registry() as reg:
        with pytest.raises(tmon.MemoryBudgetError) as ei:
            ServingEngine(pm, ServingConfig(**QUICK), device="cpu")
        assert ei.value.limit_bytes == 1 << 20
        with pytest.raises(tmon.MemoryBudgetError):
            _bert_pair()
        assert reg.get("memory_preflight_failures_total").value(
            kind="known") == 2
    with flag_scope("memory_preflight", "warn"), \
            flag_scope("memory_preflight_limit_mb", 1), \
            pytest.warns(RuntimeWarning, match="pre-flight"):
        ServingEngine(pm, ServingConfig(**QUICK), device="cpu")


# -- the Request repair and the names -------------------------------------------------
def test_request_fields_match_jax_and_past_on_token_is_keyword_only():
    """The port's ``Request`` has the JAX ``Request``'s fields in the
    JAX order, each binding positionally as there, with the same
    defaults and the same ``deadline_s`` check."""
    import dataclasses

    from paddle_tpu.serving import Request as JaxRequest
    from paddle_tpu.serving import SamplingParams as JaxSamplingParams
    from paddle_tpu_torch.serving import SamplingParams
    names = [f.name for f in dataclasses.fields(JaxRequest)]
    assert [f.name for f in dataclasses.fields(Request)] == names
    on_token, stop = (lambda r, t, x: None), (lambda ids: False)
    # every field given positionally, sampling apart (each package's own)
    args = [[1, 2, 3], 5, None, 2, on_token, 1.5, 3, stop, "t-1", "p/1",
            "r0", True, "a", "x", 7]
    j = JaxRequest(*args[:2], JaxSamplingParams(top_k=4), *args[3:])
    t = Request(*args[:2], SamplingParams(top_k=4), *args[3:])
    for f in names:
        if f == "sampling":
            assert t.sampling.top_k == j.sampling.top_k == 4
        elif f == "prompt":
            assert t.prompt.tolist() == j.prompt.tolist() == [1, 2, 3]
        else:
            assert getattr(t, f) == getattr(j, f), f
    assert (t.deadline_s, t.priority, t.stop) == (1.5, 3, stop)
    d, jd = Request([1]), JaxRequest([1])
    for f in names[3:-1]:
        assert getattr(d, f) == getattr(jd, f), f
    for bad in (0.0, -1.0):
        for cls in (Request, JaxRequest):
            with pytest.raises(ValueError, match="deadline_s"):
                cls([1], deadline_s=bad)


def test_port_metric_names_are_the_documented_jax_names(monkeypatch):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import check_metrics
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(check_metrics, "SOURCE_ROOTS", ("paddle_tpu_torch",))
    emitted = check_metrics.emitted_metrics(str(REPO))
    documented = check_metrics.documented_metrics(str(REPO))
    assert {"serve_requests_total", "train_layer_grad_norm",
            "pallas_fallback_total", "nonfinite_skips_total",
            "serve_overload", "serve_overload_transitions_total",
            "serve_watchdog_trips_total",
            "serve_deadline_slack_seconds"} <= set(emitted)
    assert set(emitted) - documented == set()
    # the resilience plane's request and flight events: JAX names, each
    # emitted by both packages, documented but for checkpoint_commit
    doc = "".join((REPO / "docs" / f).read_text() for f in (
        "OBSERVABILITY.md", "SERVING.md", "FAULT_TOLERANCE.md"))
    srcs = ["".join(p.read_text() for p in (REPO / pkg).rglob("*.py"))
            for pkg in ("paddle_tpu", "paddle_tpu_torch")]
    for name in ("expired", "shed", "cancelled", "drained", "rejected",
                 "decode_watchdog", "overload", "checkpoint_fallback",
                 "checkpoint_commit"):
        assert name == "checkpoint_commit" or name in doc, name
        assert all(f'"{name}"' in src for src in srcs), name


def test_monitor_packages_import_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.monitor, paddle_tpu_torch.testing\n"
            "import paddle_tpu_torch.profiler, paddle_tpu_torch.cost_model\n"
            "import paddle_tpu_torch.monitor.server\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
