"""Multi-tenant serving in the port (``paddle_tpu_torch``) against the JAX
package on the CPU: int8 paged KV, the quantized paged-decode and bgmv
kernels' plain versions, the LoRA adapter pools, the per-tenant quota,
the open-loop schedule and, for the slice as a whole, the two engines
serving int8 KV with two adapters mixed in one batch.

The same numpy-seeded inputs go through the JAX function (its Pallas
kernels run by the Pallas interpreter, as the JAX package's own tests run
them on the CPU) and through the port. The ``cuda``-marked cases hold
each kernel against its plain version on the card and skip without
one::

    python -m pytest --noconftest -m cuda tests/test_torch_multitenant.py
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.bgmv import MAX_RANK, bgmv, bgmv_plain
from paddle_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention_quant, paged_decode_quant_plain)
from paddle_tpu_torch.serving import (LoadSpec, LoRAManager, PagedKVCache,
                                      Request, ServingConfig, ServingEngine,
                                      build_requests, kv_cache as tkv)

# D = 64, the kernels' head dim; a wide init so greedy decoding of random
# weights does not collapse into one repeated token
WIDE = dict(hidden_size=128, num_heads=2, initializer_range=0.3)
# bench.py --serve --quick
QUICK = dict(max_batch_slots=4, block_size=8, max_context_len=128,
             prefill_buckets=(16, 32), batch_buckets=(1, 2, 4))
# the multi-tenant phase of chip_smoke.py (bench.py's full
# serve_multitenant_metrics traffic)
CHIP_SPEC = dict(num_requests=24, rate_rps=6.0, prompt_len_range=(16, 64),
                 max_new_range=(8, 24), vocab_size=50304, seed=23,
                 shared_prefix_len=32, prefix_pool_size=2, tenants=4,
                 adapter_pool=2)


# -- int8 page writes ---------------------------------------------------------
def _quant_writes(rng, H=2, D=64):
    """Prefill-shaped rows (tails past MB*bs, an all-scratch padded row,
    an all-zero token row), then a decode-shaped write."""
    tbl = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    new = rng.randn(3, 16, H, D).astype(np.float32) * 3
    new[0, 2] = 0.0                           # absmax 0: scale is eps
    dec = rng.randn(3, 1, H, D).astype(np.float32)
    dpos = np.array([11, 5, 0], np.int32)
    return tbl, new, dec, dpos


def test_write_pages_quant_bit_equal_to_jax():
    import jax.numpy as jnp
    from paddle_tpu.serving import kv_cache as jkv
    P, bs, H, D = 9, 4, 2, 64
    tbl, new, dec, dpos = _quant_writes(np.random.RandomState(1), H, D)
    jp = jnp.zeros((P, bs, H, D), jnp.int8)
    js = jnp.zeros((P, bs, H), jnp.float32)
    tp = torch.zeros(P, bs, H, D, dtype=torch.int8)
    ts = torch.zeros(P, bs, H)
    for x, pos in ((new, np.zeros(3, np.int32)), (dec, dpos)):
        jp, js = jkv.write_pages_quant(jp, js, jnp.asarray(x),
                                       jnp.asarray(tbl), jnp.asarray(pos))
        out = tkv.write_pages_quant(tp, ts, torch.from_numpy(x),
                                    torch.from_numpy(tbl),
                                    torch.from_numpy(pos))
        assert out[0] is tp and out[1] is ts           # in place
    # page 0 takes the colliding scratch writes, in no defined order
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], np.asarray(js)[1:])
    assert np.abs(tp.numpy()).max() == 127
    live = tbl[:2]          # their first 8 positions lie off page 0
    got = tkv.gather_pages_quant(tp, ts, torch.from_numpy(live))
    ref = jkv.gather_pages_quant(jp, js, jnp.asarray(live))
    np.testing.assert_array_equal(got.numpy()[:, :8],
                                  np.asarray(ref)[:, :8])
    np.testing.assert_array_equal(
        tkv.dequant_pages(tp, ts).numpy()[1:],
        np.asarray(jkv.dequant_pages(jp, js))[1:])


@pytest.mark.parametrize("quant", ["", "int8"])
def test_cache_pools_and_bytes_per_token_match_jax(quant):
    from paddle_tpu.core.flags import flag_scope as jax_flag_scope
    from paddle_tpu.serving import kv_cache as jkv
    geo = dict(num_pages=5, block_size=4, max_slots=2,
               max_blocks_per_slot=2)
    with jax_flag_scope("serve_kv_quant", quant):
        jc = jkv.PagedKVCache(24, 16, 64, **geo)
    with flag_scope("serve_kv_quant", quant):
        tc = PagedKVCache(24, 16, 64, device="cpu", **geo)
    assert tc.quant == jc.quant == quant
    assert tc.kv_bytes_per_token() == jc.kv_bytes_per_token() \
        == (52224 if quant else 196608)
    if quant:
        assert tc.k.dtype == tc.v.dtype == torch.int8
        assert tc.k.shape == (24, 5, 4, 16, 64)
        assert tc.k_scale.shape == tc.v_scale.shape == (24, 5, 4, 16)
        assert tuple(jc.k[1].shape) == tuple(tc.k_scale.shape)
    else:
        assert tc.k_scale is None and tc.k.dtype == torch.float32
    with flag_scope("serve_kv_quant", "int4"), \
            pytest.raises(ValueError, match="serve_kv_quant"):
        PagedKVCache(1, 1, 64, device="cpu", **geo)


# -- kernel 10: quantized paged decode ----------------------------------------
def _quant_decode_inputs(seed, H=2, D=64, bs=4, MB=4, P=12):
    """Slots at different fill levels, a fresh slot at pos 0 and an
    inactive all-scratch row, written through the quantizing scatter."""
    rng = np.random.RandomState(seed)
    tbl = np.zeros((5, MB), np.int32)
    tbl[0, :3] = [1, 2, 3]
    tbl[1, :1] = [4]
    tbl[2, :4] = [6, 7, 8, 9]
    tbl[3, :1] = [10]                     # fresh slot, pos 0
    pos = np.array([9, 2, 14, 0, 0], np.int32)   # row 4: all scratch
    kp = torch.zeros(P, bs, H, D, dtype=torch.int8)
    vp = torch.zeros_like(kp)
    ks, vs = torch.zeros(P, bs, H), torch.zeros(P, bs, H)
    for b in range(4):
        n = int(pos[b]) + 1
        row = torch.from_numpy(tbl[b:b + 1])
        z = torch.zeros(1, dtype=torch.int32)
        tkv.write_pages_quant(kp, ks, torch.from_numpy(
            rng.randn(1, n, H, D).astype(np.float32)), row, z)
        tkv.write_pages_quant(vp, vs, torch.from_numpy(
            rng.randn(1, n, H, D).astype(np.float32)), row, z)
    q = torch.from_numpy(rng.randn(5, H, D).astype(np.float32))
    return q, kp, ks, vp, vs, torch.from_numpy(tbl), torch.from_numpy(pos)


def test_quant_paged_decode_matches_jax_kernel_and_composition():
    """The first parity test of kernel 10: the port's plain version
    against the Pallas kernel (interpreted) and the JAX package's
    gather_pages_quant + masked SDPA fallback."""
    import jax.numpy as jnp
    from paddle_tpu.ops.attention import sdpa_array as jax_sdpa
    from paddle_tpu.ops.pallas.paged_decode import \
        paged_decode_attention_quant as jax_kernel
    from paddle_tpu.serving.kv_cache import gather_pages_quant
    args = _quant_decode_inputs(0)
    q, kp, ks, vp, vs, tbl, pos = args
    scale = 1.0 / math.sqrt(q.shape[-1])
    j = [jnp.asarray(t.numpy()) for t in args]
    ref = np.asarray(jax_kernel(*j, scale=scale))
    gk = gather_pages_quant(j[1], j[2], j[5])
    gv = gather_pages_quant(j[3], j[4], j[5])
    cols = jnp.arange(gk.shape[1])
    mask = jnp.where(cols[None, :] <= j[6][:, None], 0.0,
                     -1e30)[:, None, None, :]
    composed = np.asarray(jax_sdpa(j[0][:, None], gk, gv, mask=mask,
                                   dropout_p=0.0, is_causal=False))[:, 0]
    got = paged_decode_attention_quant(*args, scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), composed, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), paged_decode_quant_plain(*args, scale).numpy())


def test_quant_paged_decode_wrapper_checks_arguments():
    q, kp, ks, vp, vs, tbl, pos = _quant_decode_inputs(1)
    with pytest.raises(ValueError, match=r"\[P,bs,H\]"):
        paged_decode_attention_quant(q, kp, ks[:, :2], vp, vs, tbl, pos,
                                     0.1)
    with pytest.raises(ValueError, match="do not match"):
        paged_decode_attention_quant(q, kp, ks, vp, vs, tbl[:3], pos, 0.1)


# -- kernel 11: bgmv ----------------------------------------------------------
def _bgmv_inputs(seed, B=4, S=3, E=128, r=4, O=384, A=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, E).astype(np.float32)
    a = rng.randn(A, r, E).astype(np.float32)
    b = rng.randn(A, r, O).astype(np.float32)
    a[0] = b[0] = 0.0                   # the zero adapter
    ids = np.array([2, 0, 1, 2][:B], np.int32)
    return x, a, b, ids


@pytest.mark.parametrize("S", [1, 3], ids=["decode", "prefill"])
def test_bgmv_plain_matches_jax_kernel_and_oracle(S):
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.bgmv import bgmv as jax_bgmv
    from paddle_tpu.ops.pallas.bgmv import bgmv_xla
    inputs = _bgmv_inputs(S, S=S)
    x, a, b, ids = inputs
    j = [jnp.asarray(t) for t in inputs]
    refs = (np.asarray(jax_bgmv(*j)), np.asarray(bgmv_xla(*j)))
    got = bgmv(*map(torch.from_numpy, inputs))
    assert got.shape == (4, S, 384) and got.dtype == torch.float32
    for ref in refs:
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), err
    assert np.all(got.numpy()[1] == 0.0)            # row 1 on adapter 0
    assert np.abs(got.numpy()[[0, 2, 3]]).min(axis=-1).max() > 0
    np.testing.assert_array_equal(
        got.numpy(), bgmv_plain(*map(torch.from_numpy, inputs)).numpy())


@pytest.mark.parametrize("S", [1, 3], ids=["decode", "prefill"])
def test_bgmv_plain_at_ragged_rank_and_widths_matches_jax_kernel(S):
    """r = 7 and E = O = 1000, which the kernel's cluster splits into
    slices that are not multiples of its tiles (and takes with 4-byte
    copies): the plain version, which the kernel is held to on the card,
    against the JAX kernel run by the Pallas interpreter."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.bgmv import bgmv as jax_bgmv
    inputs = _bgmv_inputs(7 + S, S=S, E=1000, r=7, O=1000, A=5)
    inputs[3][:] = [4, 0, 2, 4]
    ref = np.asarray(jax_bgmv(*map(jnp.asarray, inputs)))
    got = bgmv(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == (4, S, 1000)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.all(got[1] == 0.0) and not np.signbit(got[1]).any()


def test_bgmv_wrapper_checks_arguments():
    x, a, b, ids = map(torch.from_numpy, _bgmv_inputs(0))
    with pytest.raises(ValueError, match=r"\[A,r,E\]"):
        bgmv(x, a[:, :, :64], b, ids)
    with pytest.raises(ValueError, match="do not match"):
        bgmv(x, a, b, ids[:2])
    assert bgmv(x.to(torch.bfloat16), a, b, ids).dtype == torch.bfloat16


def test_new_wrappers_never_take_the_plain_version_off_the_cpu():
    """Meta tensors stand in for a device that has no kernel here."""
    m = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bgmv(torch.empty(2, 1, 64, **m), torch.empty(3, 4, 64, **m),
             torch.empty(3, 4, 96, **m),
             torch.empty(2, dtype=torch.int32, **m))
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention_quant(
            torch.empty(1, 2, 64, **m),
            torch.empty(3, 4, 2, 64, dtype=torch.int8, **m),
            torch.empty(3, 4, 2, **m),
            torch.empty(3, 4, 2, 64, dtype=torch.int8, **m),
            torch.empty(3, 4, 2, **m),
            torch.empty(1, 2, dtype=torch.int32, **m),
            torch.empty(1, dtype=torch.int32, **m), 0.125)


# -- LoRAManager --------------------------------------------------------------
def _adapter(rng, rank=4, scale=0.5, L=2, E=64, O=192):
    return (rng.standard_normal((L, rank, E)).astype(np.float32) * scale,
            rng.standard_normal((L, rank, O)).astype(np.float32) * scale)


def test_lora_manager_load_unload_refcount():
    rng = np.random.default_rng(5)
    mgr = LoRAManager(2, 64, 192, max_adapters=2, rank=4, device="cpu")
    w1 = _adapter(rng)
    r1 = mgr.load_adapter("t0/a", weights=w1)
    r2 = mgr.load_adapter("t1/b", weights=_adapter(rng))
    assert (r1, r2) == (1, 2) and mgr.num_loaded == 2
    np.testing.assert_array_equal(mgr.a[:, r1].numpy(), w1[0])
    np.testing.assert_array_equal(mgr.b[:, r1].numpy(), w1[1])
    assert float(mgr.a[:, 0].abs().max()) == 0.0       # the zero adapter
    assert mgr.load_adapter("t0/a", weights=_adapter(rng)) == r1  # no-op
    np.testing.assert_array_equal(mgr.a[:, r1].numpy(), w1[0])
    assert mgr.swaps == 2
    with pytest.raises(RuntimeError, match="pool full"):
        mgr.load_adapter("t2/c", weights=_adapter(rng))
    assert mgr.acquire("t0/a") == r1
    with pytest.raises(RuntimeError, match="referenced"):
        mgr.unload_adapter("t0/a")
    mgr.release("t0/a")
    mgr.unload_adapter("t0/a")
    assert mgr.row("t0/a") is None
    assert float(mgr.a[:, r1].abs().max()) == 0.0
    assert float(mgr.b[:, r1].abs().max()) == 0.0
    assert mgr.load_adapter("t2/c", weights=_adapter(rng)) == r1  # reused
    with pytest.raises(RuntimeError, match="without a live reference"):
        mgr.release("t1/b")
    with pytest.raises(KeyError, match="not loaded"):
        mgr.acquire("t0/a")
    rows = mgr.rows_for([None, "t1/b", "t2/c"])
    assert rows.dtype == torch.int32 and rows.tolist() == [0, r2, r1]


def test_lora_manager_rejects_bad_shapes_and_sources():
    rng = np.random.default_rng(6)
    mgr = LoRAManager(2, 64, 192, max_adapters=1, rank=4, device="cpu")
    a, b = _adapter(rng)
    with pytest.raises(ValueError, match="this manager serves"):
        mgr.load_adapter("bad", weights=(a[:, :2], b))
    with pytest.raises(ValueError, match="exactly one"):
        mgr.load_adapter("bad", weights=(a, b), path="/nope")
    with pytest.raises(NotImplementedError, match="distributed/"):
        mgr.load_adapter("ck", path="/nope")
    assert mgr.num_loaded == 0 and float(mgr.a.abs().max()) == 0.0
    from paddle_tpu_torch.serving import save_adapter_checkpoint
    with pytest.raises(NotImplementedError, match="distributed/"):
        save_adapter_checkpoint("/nope", a, b)


# -- the slice as a whole -----------------------------------------------------
@pytest.fixture(scope="module")
def wide():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    paddle.seed(0)
    jax_model = JaxGPT(jax_gpt_tiny(**WIDE))
    jax_model.eval()
    named = {k: np.asarray(v._data)
             for k, v in jax_model.state_dict().items()}
    port = load_jax_weights(GPTForPretraining(gpt_tiny(**WIDE),
                                              device="cpu"), named)
    return jax_model, port


def _mt_specs():
    """Six prompts, each served twice: on an adapter (two adapters mixed
    in one batch) and on the base model."""
    rng = np.random.RandomState(3)
    specs = []
    for i in range(6):
        p = rng.randint(0, 256, (int(rng.randint(8, 25)),))
        n = int(rng.randint(4, 13))
        specs += [(p, n, ("t0/a", "t1/b")[i % 2]), (p, n, None)]
    return specs


@pytest.mark.parametrize("num_pages", [None, 12],
                         ids=["resident", "preempting"])
def test_int8_lora_engine_greedy_token_exact_vs_jax_engine(wide,
                                                           num_pages):
    from paddle_tpu.core.flags import flag_scope as jax_flag_scope
    from paddle_tpu.serving import Request as JaxRequest
    from paddle_tpu.serving import ServingConfig as JaxServingConfig
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    jax_model, port_model = wide
    rng = np.random.default_rng(11)
    adapters = {n: _adapter(rng, E=128, O=384) for n in ("t0/a", "t1/b")}
    cfg = dict(QUICK, num_pages=num_pages, lora_adapters=2, lora_rank=4)
    specs = _mt_specs()
    with jax_flag_scope("serve_kv_quant", "int8"):
        je = JaxServingEngine(jax_model, JaxServingConfig(**cfg))
    with flag_scope("serve_kv_quant", "int8"):
        te = ServingEngine(port_model, ServingConfig(**cfg), device="cpu")
    assert te.cache.quant == "int8" and te.cache.k.dtype == torch.int8
    for e in (je, te):
        for name, w in adapters.items():
            e.lora.load_adapter(name, weights=w)
    js = [je.submit(JaxRequest(p, max_new_tokens=n, adapter=ad))
          for p, n, ad in specs]
    ts = [te.submit(Request(p, max_new_tokens=n, adapter=ad))
          for p, n, ad in specs]
    je.run()
    te.run()
    for a, b, (_, n, _) in zip(js, ts, specs):
        assert b.outcome == "completed" and len(b.generated) == n
        assert b.generated == a.generated
    # the adapters (scale 0.5) change what the model says
    assert any(ts[i].generated != ts[i + 1].generated
               for i in range(0, len(ts), 2))
    assert te.stats()["preemptions"] == je.scheduler.stats["preemptions"]
    if num_pages is not None:
        assert te.stats()["preemptions"] > 0
    lora = te.stats()["lora"]
    assert lora["loaded"] == ["t0/a", "t1/b"] and lora["swaps"] == 2
    assert lora["refcounts"] == {"t0/a": 0, "t1/b": 0}
    m = te.metrics_summary()
    assert m["kv_bytes_per_token"] == je.cache.kv_bytes_per_token()


def test_engine_refuses_unloaded_adapters(wide):
    port_model = wide[1]
    plain = ServingEngine(port_model, ServingConfig(**QUICK), device="cpu")
    with pytest.raises(ValueError, match="no LoRA manager"):
        plain.submit(Request([1, 2, 3], adapter="x"))
    eng = ServingEngine(port_model, ServingConfig(
        lora_adapters=1, lora_rank=4, **QUICK), device="cpu")
    with pytest.raises(ValueError, match="'x' is not loaded"):
        eng.submit(Request([1, 2, 3], adapter="x"))
    # unloaded between submit and admission: that request fails alone
    eng.lora.load_adapter("x", weights=_adapter(np.random.default_rng(0),
                                                E=128, O=384))
    st = eng.submit(Request([1, 2, 3], max_new_tokens=2, adapter="x"))
    ok = eng.submit(Request([4, 5, 6], max_new_tokens=2))
    eng.lora.unload_adapter("x")
    eng.run()
    assert st.outcome == "failed" and "not loaded" in st.failure
    assert ok.outcome == "completed" and len(ok.generated) == 2


# -- per-tenant quota ---------------------------------------------------------
def _quota_run(engine_cls, request_cls, model, **kw):
    eng = engine_cls(model, **kw)
    sts = [eng.submit(request_cls([2 + i, 3, 4], max_new_tokens=6,
                                  tenant="a")) for i in range(3)]
    sts.append(eng.submit(request_cls([9, 10, 11], max_new_tokens=6,
                                      tenant="b")))
    eng.step()
    first = sorted(st.request.tenant for _, st in eng.scheduler.active())
    eng.run()
    return (first, [st.outcome for st in sts],
            [list(st.generated) for st in sts],
            dict(eng.scheduler.tenant_deferrals),
            eng.scheduler.stats["quota_deferred"])


def test_tenant_quota_scenario_matches_jax():
    """The JAX package's quota scenario: tenant a holds one slot of its
    three requests, b is admitted past the blocked ones, and the same
    deferrals are counted in both packages."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu.serving import Request as JaxRequest
    from paddle_tpu.serving import ServingConfig as JaxServingConfig
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = load_jax_weights(GPTForPretraining(gpt_tiny(), device="cpu"),
                          named)
    cfg = dict(max_batch_slots=3, block_size=4, max_context_len=64,
               prefill_buckets=(8, 16), batch_buckets=(1, 2),
               tenant_quota=1)
    ref = _quota_run(JaxServingEngine, JaxRequest, jm,
                     config=JaxServingConfig(**cfg))
    got = _quota_run(ServingEngine, Request, tm,
                     config=ServingConfig(**cfg), device="cpu")
    assert got == ref
    first, outcomes, _, deferrals, total = got
    assert first == ["a", "b"] and outcomes == ["completed"] * 4
    assert deferrals["a"] > 0 and "b" not in deferrals
    assert total == sum(deferrals.values())


def test_untenanted_requests_never_quota_limited(wide):
    eng = ServingEngine(wide[1], ServingConfig(tenant_quota=1, **QUICK),
                        device="cpu")
    sts = [eng.submit(Request([3 + i, 4, 5], max_new_tokens=4))
           for i in range(3)]
    eng.step()
    assert len(eng.scheduler.active()) == 3
    assert eng.scheduler.tenant_deferrals == {}
    eng.run()
    assert all(st.outcome == "completed" for st in sts)
    assert eng.stats()["tenant_deferrals"] == {}


# -- the open-loop schedule ---------------------------------------------------
@pytest.mark.parametrize("spec", [
    CHIP_SPEC,
    dict(num_requests=30, rate_rps=50.0, prompt_len_range=(4, 9), seed=5,
         shared_prefix_len=8, prefix_pool_size=3, tenants=3,
         adapter_pool=3, prefix_zipf=1.5),
    dict(num_requests=12, rate_rps=8.0, seed=7, shared_prefix_len=6),
], ids=["chip_smoke", "three_tenants", "one_prefix_pool"])
def test_build_requests_schedule_identical_to_jax(spec):
    from paddle_tpu.serving import LoadSpec as JaxLoadSpec
    from paddle_tpu.serving import build_requests as jax_build
    ref = jax_build(JaxLoadSpec(**spec))
    got = build_requests(LoadSpec(**spec))
    assert len(got) == len(ref) == spec["num_requests"]
    for (ta, ra), (tb, rb) in zip(ref, got):
        assert ta == tb
        assert ra.prompt.dtype == rb.prompt.dtype
        assert ra.prompt.tobytes() == rb.prompt.tobytes()
        assert (ra.max_new_tokens, ra.tenant, ra.adapter) == \
            (rb.max_new_tokens, rb.tenant, rb.adapter)
    if spec.get("adapter_pool"):
        assert len({r.adapter for _, r in got}) > 1
        assert all(r.adapter.startswith(r.tenant + "/") for _, r in got)


# -- the kernels on the card --------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_quant_paged_decode_kernel_matches_plain_on_card(cuda):
    args = [t.to(cuda) for t in _quant_decode_inputs(2)]
    scale = 1.0 / math.sqrt(args[0].shape[-1])
    before = kernels.PAGED_DECODE_QUANT.launches
    got = paged_decode_attention_quant(*args, scale)
    assert kernels.PAGED_DECODE_QUANT.launches == before + 1
    ref = paged_decode_quant_plain(*args, scale)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4


# positions at the edges of the kernel's split of a slot over the blocks of
# its cluster (up to 8: fewer positions than blocks, one each, a page edge,
# the last position), then an inactive slot (pos 0, all-scratch row)
EDGE_POS = [0, 1, 7, 8, 63, 64, 200, 511, 0]


def _edge_table(pos, bs, MB, seed):
    """Block-table rows for slots at ``pos``, each slot's pages drawn
    from a permutation of pages 1..P-1, the last row all scratch page 0.
    Returns the table and P."""
    need = [int(p) // bs + 1 for p in pos[:-1]]
    P = sum(need) + 1
    perm = np.random.RandomState(seed).permutation(np.arange(1, P))
    tbl = np.zeros((len(pos), MB), np.int32)
    used = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[used:used + n]
        used += n
    return tbl, P


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_quant_paged_decode_cluster_split_edges_on_card(cuda, D):
    """Every slot of :data:`EDGE_POS` within 1e-4 of the plain version,
    over int8 pools written by the quantizing scatter (scratch page 0
    holds data too), and two launches give identical bits."""
    H, bs, MB = 2, 16, 32
    pos = np.array(EDGE_POS, np.int32)
    tbl, P = _edge_table(pos, bs, MB, seed=D)
    g = torch.Generator(device=cuda).manual_seed(D)
    every = torch.arange(P, dtype=torch.int32, device=cuda)[None]
    start = torch.zeros(1, dtype=torch.int32, device=cuda)
    pools = []
    for _ in range(2):
        pages = torch.zeros(P, bs, H, D, dtype=torch.int8, device=cuda)
        scales = torch.zeros(P, bs, H, device=cuda)
        tkv.write_pages_quant(pages, scales, torch.randn(
            1, P * bs, H, D, device=cuda, generator=g), every, start)
        pools.append((pages, scales))
    (kp, ks), (vp, vs) = pools
    q = torch.randn(len(pos), H, D, device=cuda, generator=g)
    args = (q, kp, ks, vp, vs, torch.from_numpy(tbl).to(cuda),
            torch.from_numpy(pos).to(cuda), 1.0 / math.sqrt(D))
    before = kernels.PAGED_DECODE_QUANT.launches
    got = paged_decode_attention_quant(*args)
    again = paged_decode_attention_quant(*args)
    assert kernels.PAGED_DECODE_QUANT.launches == before + 2
    ref = paged_decode_quant_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("S", [1, 40])
def test_bgmv_kernel_matches_plain_on_card(cuda, dtype, tol, S):
    x, a, b, ids = (torch.from_numpy(t).to(cuda)
                    for t in _bgmv_inputs(S, S=S, E=1024, r=8, O=3072))
    x = x.to(dtype)
    before = kernels.BGMV.launches
    got = bgmv(x, a, b, ids)
    assert kernels.BGMV.launches == before + 1
    ref = bgmv_plain(x, a, b, ids)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= tol
    assert bool((got[1] == 0).all())                 # the zero adapter
    with pytest.raises(ValueError, match="ranks up to"):
        r = MAX_RANK + 1
        bgmv(x, torch.zeros(3, r, 1024, device=cuda),
             torch.zeros(3, r, 3072, device=cuda), ids)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 7, 8, 64])
@pytest.mark.parametrize("E,O", [(1000, 1000), (1024, 3072), (1000, 3072),
                                 (1024, 1000)])
@pytest.mark.parametrize("S", [1, 17, 256])
@pytest.mark.parametrize("ids", [[2, 0, 1, 2], [1, 1, 1, 1]],
                         ids=["mixed", "one-adapter"])
def test_bgmv_cluster_edges_on_card(cuda, r, E, O, S, ids):
    """The cluster kernel where its slices do not tile: r not a multiple
    of 8, E and O not multiples of the cluster's slices (4-byte copies),
    token counts past and short of a tile, and every row on one adapter.
    Within BGMV_TOL of the plain version (1e-5 of the largest value in
    f32, one bf16 ulp in bf16); a zero-adapter row is exactly +0.0; two
    launches give the same bits."""
    x, a, b, ids_t = (torch.from_numpy(t).to(cuda) for t in _bgmv_inputs(
        r + E + O + S, S=S, E=E, r=r, O=O))
    ids_t.copy_(torch.tensor(ids, dtype=torch.int32))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        xd = x.to(dtype)
        before = kernels.BGMV.launches
        got = bgmv(xd, a, b, ids_t)
        again = bgmv(xd, a, b, ids_t)
        assert kernels.BGMV.launches == before + 2
        ref = bgmv_plain(xd, a, b, ids_t)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        err = (got.float() - ref.float()).abs().max() / \
            ref.float().abs().max()
        assert err.item() <= tol
        for i, k in enumerate(ids):
            if k == 0:
                assert (got[i] == 0).all() and not got[i].signbit().any()
