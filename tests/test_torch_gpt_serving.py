"""The port's GPT and serving engine (``paddle_tpu_torch``) against the
JAX package on the CPU.

The JAX model is built from a seed, its weights are copied into the port
by name (``models.convert``), and the same numpy-seeded token ids go
through both: the no-cache forward, the paged prefill and decode forward
and, for the slice as a whole, the two serving engines, which must give
the same greedy tokens with and without recompute-preemption.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu.serving import (Request as JaxRequest,
                                SamplingParams as JaxSamplingParams,
                                ServingConfig as JaxServingConfig,
                                ServingEngine as JaxServingEngine)
from paddle_tpu_torch.core import resolve_device
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny,
                                     load_jax_weights,
                                     torch_state_dict_from_jax)
from paddle_tpu_torch.serving import (BlockAllocator, PagedCacheView,
                                      PagedKVCache, Request, SamplingParams,
                                      ServingConfig, ServingEngine,
                                      filtered_logits, sample_tokens)

REPO = Path(__file__).resolve().parents[1]

# D = 64, the flash kernel's head dim
TINY = dict(hidden_size=128, num_heads=2)
# a wide init, so that greedy decoding of random weights does not
# collapse into one repeated token
WIDE = dict(TINY, initializer_range=0.3)
# bench.py --serve --quick
QUICK = dict(max_batch_slots=4, block_size=8, max_context_len=128,
             prefill_buckets=(16, 32), batch_buckets=(1, 2, 4))


def _models(cfg):
    """A seeded JAX model, its weights as numpy arrays, and the port's
    model with those weights copied in."""
    paddle.seed(0)
    jax_model = JaxGPT(jax_gpt_tiny(**cfg))
    jax_model.eval()
    named = {k: np.asarray(v._data)
             for k, v in jax_model.state_dict().items()}
    port = load_jax_weights(GPTForPretraining(gpt_tiny(**cfg), device="cpu"),
                            named)
    return jax_model, named, port


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


@pytest.fixture(scope="module")
def wide():
    return _models(WIDE)


# -- weights --------------------------------------------------------------------
def test_converter_round_trip_and_layouts(tiny):
    _, named, port_model = tiny
    assert len(named) == 28
    assert named["gpt.layers.0.attn.qkv_weight"].shape == (128, 3, 2, 64)
    assert named["gpt.layers.0.attn.out_weight"].shape == (2, 64, 128)
    assert named["gpt.layers.1.mlp.w_in"].shape == (128, 512)
    sd = port_model.state_dict()
    assert set(sd) == set(named)
    for k, v in named.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    back = torch_state_dict_from_jax({k: t.numpy() for k, t in sd.items()})
    for k, v in named.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_converter_is_strict(tiny):
    named = dict(tiny[1])
    model = GPTForPretraining(gpt_tiny(**TINY), device="cpu")
    missing = {k: v for k, v in named.items() if "final_norm" not in k}
    with pytest.raises(KeyError, match="final_norm"):
        load_jax_weights(model, missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_weights(model, {**named, "gpt.extra": np.zeros(1)})
    bad = dict(named)
    bad["gpt.layers.0.mlp.w_in"] = np.zeros((512, 128), np.float32)
    with pytest.raises(ValueError, match="w_in"):
        load_jax_weights(model, bad)


# -- forward --------------------------------------------------------------------
def test_no_cache_logits_match_jax(tiny):
    jax_model, _, port_model = tiny
    ids = np.random.RandomState(0).randint(0, 256, (2, 40)).astype(np.int32)
    ref = np.asarray(jax_model(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids.astype(np.int64)))
    assert got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_paged_prefill_and_decode_logits_match_jax(tiny):
    """One bucketed prefill (a padded row included) and five decode steps
    over the paged pools, in both packages."""
    jm, _, port_model = tiny
    cfg = port_model.cfg
    geo = dict(num_pages=12, block_size=4, max_slots=3,
               max_blocks_per_slot=6)
    jc = jkv.PagedKVCache(cfg.num_layers, cfg.num_heads, cfg.head_dim,
                          **geo)
    tc = PagedKVCache(cfg.num_layers, cfg.num_heads, cfg.head_dim,
                      device="cpu", **geo)
    lens = [7, 3]
    for c in (jc, tc):
        assert c.alloc_slot(0, lens[0]) and c.alloc_slot(1, lens[1])
    rng = np.random.RandomState(1)
    ids = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 256, n)
    rows = [0, 1, None]                     # row 2: padding, all scratch

    def jax_step(tokens, pos, rows):
        view = jkv.PagedCacheView(jc.k, jc.v, jc.table_array(rows))
        with paddle.no_grad():
            lg, nc = jm(paddle.to_tensor(tokens), caches=view,
                        cache_pos=paddle.to_tensor(pos))
        jc.update(nc.k._data, nc.v._data)
        return np.asarray(lg._data)

    def port_step(tokens, pos, rows):
        view = PagedCacheView(tc.k, tc.v, tc.table_array(rows))
        with torch.no_grad():
            return port_model(torch.from_numpy(tokens.astype(np.int64)),
                              caches=view,
                              cache_pos=torch.from_numpy(pos)).numpy()

    zeros = np.zeros(3, np.int32)
    ref, got = jax_step(ids, zeros, rows), port_step(ids, zeros, rows)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], atol=1e-4,
                                   rtol=0)
    last = ref[[0, 1], [n - 1 for n in lens]]          # [2, V]
    seq_len = list(lens)
    for _ in range(5):
        tokens = np.zeros((3, 1), np.int32)
        pos = np.zeros(3, np.int32)
        for i in range(2):
            tokens[i, 0] = last[i].argmax()
            pos[i] = seq_len[i]
            seq_len[i] += 1
            for c in (jc, tc):
                assert c.extend_slot(i, seq_len[i])
        drows = [0, 1, None]                # slot 2 inactive
        ref = jax_step(tokens, pos, drows)
        got = port_step(tokens, pos, drows)
        np.testing.assert_allclose(got[:2], ref[:2], atol=1e-4, rtol=0)
        assert (got[:2, 0].argmax(-1) == ref[:2, 0].argmax(-1)).all()
        last = ref[:2, 0]
    np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jc.k)[:, 1:],
                               atol=1e-4, rtol=0)


# -- the slice as a whole ----------------------------------------------------------
@pytest.mark.parametrize("num_pages", [None, 12],
                         ids=["resident", "preempting"])
def test_engine_greedy_token_exact_vs_jax_engine(wide, num_pages):
    jax_model, _, port_model = wide
    rng = np.random.RandomState(0)
    specs = [(rng.randint(0, 256, (int(rng.randint(8, 25)),)),
              int(rng.randint(4, 13))) for _ in range(6)]
    je = JaxServingEngine(jax_model,
                          JaxServingConfig(num_pages=num_pages, **QUICK))
    js = [je.submit(JaxRequest(p, max_new_tokens=n,
                               sampling=JaxSamplingParams()))
          for p, n in specs]
    je.run()
    te = ServingEngine(port_model, ServingConfig(num_pages=num_pages,
                                                 **QUICK), device="cpu")
    ts = [te.submit(Request(p, max_new_tokens=n, sampling=SamplingParams()))
          for p, n in specs]
    te.run()
    for a, b, (_, n) in zip(js, ts, specs):
        assert b.outcome == "completed" and len(b.generated) == n
        assert b.generated == a.generated
    assert len({t for st in ts for t in st.generated}) > 6
    assert te.stats()["preemptions"] == je.scheduler.stats["preemptions"]
    if num_pages is not None:
        assert te.stats()["preemptions"] > 0
    m = te.metrics_summary()
    assert m["requests_completed"] == 6 and m["tokens_per_sec"] > 0
    assert m["decode_step_p99_s"] >= m["decode_step_p50_s"] > 0


def test_engines_serve_the_weights_they_were_built_with():
    """Both engines snapshot the model's parameters and buffers when they
    are built: negating every weight afterwards changes no token of
    either, and they still agree token for token; an engine built after
    the change serves the new weights."""
    jax_model, named, port_model = _models(WIDE)
    rng = np.random.RandomState(3)
    specs = [(rng.randint(0, 256, (int(rng.randint(8, 25)),)),
              int(rng.randint(4, 13))) for _ in range(4)]

    def port_tokens(engine):
        reqs = [engine.submit(Request(p, max_new_tokens=n,
                                      sampling=SamplingParams()))
                for p, n in specs]
        engine.run()
        return [r.generated for r in reqs]

    before = port_tokens(ServingEngine(port_model, ServingConfig(**QUICK),
                                       device="cpu"))
    je = JaxServingEngine(jax_model, JaxServingConfig(**QUICK))
    te = ServingEngine(port_model, ServingConfig(**QUICK), device="cpu")
    jax_model.set_state_dict({k: -v for k, v in named.items()})
    with torch.no_grad():
        for t in (*port_model.parameters(), *port_model.buffers()):
            if t.is_floating_point():
                t.neg_()
    js = [je.submit(JaxRequest(p, max_new_tokens=n,
                               sampling=JaxSamplingParams()))
          for p, n in specs]
    je.run()
    assert port_tokens(te) == [r.generated for r in js] == before
    assert port_tokens(ServingEngine(port_model, ServingConfig(**QUICK),
                                     device="cpu")) != before


def test_engine_without_device_never_runs_on_the_cpu(tiny):
    port_model = tiny[2]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(port_model, ServingConfig(**QUICK))
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForPretraining(gpt_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# -- sampling ---------------------------------------------------------------------
def test_filtered_logits_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(4, 64).astype(np.float32) * 3
    temps = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 20, 1], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.8], np.float32)
    ref = np.asarray(jsampling.filtered_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = filtered_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.from_numpy(top_k.astype(np.int64)),
                          torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_greedy_sample_tokens_is_first_max_argmax():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 5.0, 5.0],
                           [0.0, 0.0, 0.0, 9.0]])
    z = torch.zeros(3)
    toks = sample_tokens(logits, z, torch.zeros(3, dtype=torch.int64),
                         torch.ones(3))
    assert toks.tolist() == [1, 0, 3]
    ref = jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)
    assert toks.tolist() == np.asarray(ref).tolist()
    # a sampled row draws from the caller's generator, greedy rows do not
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 1.0, 0.0])
    args = (logits, temps, torch.zeros(3, dtype=torch.int64), torch.ones(3))
    a, b = sample_tokens(*args, generator=g1), sample_tokens(*args,
                                                              generator=g2)
    assert a.tolist() == b.tolist() and a[0] == 1 and a[2] == 3


# -- page allocator ---------------------------------------------------------------
def test_block_allocator_refcounts_and_all_or_nothing():
    ref = jkv.BlockAllocator(6)
    alloc = BlockAllocator(6)
    for a in (ref, alloc):
        assert a.free_pages == 5 and a.pages_in_use == 0
    got = alloc.alloc(3)
    assert got == ref.alloc(3) == [1, 2, 3]
    assert alloc.alloc(3) is None and alloc.free_pages == 2   # no change
    alloc.incref(2)
    assert alloc.refcount(2) == 2
    alloc.free([2])
    assert alloc.refcount(2) == 1 and alloc.free_pages == 2
    alloc.free([1, 2, 3])
    assert alloc.free_pages == 5 and alloc.pages_in_use == 0
    with pytest.raises(ValueError, match="double free"):
        alloc.free([1])
    with pytest.raises(ValueError, match="outside"):
        alloc.free([0])
    with pytest.raises(ValueError, match="unallocated"):
        alloc.incref(4)
    with pytest.raises(ValueError):
        BlockAllocator(1)


# -- the package stands alone -------------------------------------------------------
def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "paddle_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert {"paddle_tpu_torch.serving.engine",
            "paddle_tpu_torch.ops.kernels.paged_decode"} <= set(mods)
