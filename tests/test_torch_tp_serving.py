"""Tensor-parallel serving of the port against the JAX engine, on the CPU.

One gloo world of two ranks (``_torch_tp_serve_workers``) serves
``gpt_tiny`` at mp = 2 (``ServingConfig.mesh``) from the JAX model's
weights, with ``tests/test_serving_fleet.py``'s engine config and
prompts; each rank's greedy tokens are held against the JAX engine
without a mesh and on a ``{"mp": 2}`` mesh of the virtual CPU devices
(f32 and int8 pools, a LoRA adapter), and against the JAX model's
greedy oracle (speculative decoding, the prefix cache with chunked
prefill, ``generate``). Tokens are compared exactly.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn_mod import spawn

import _torch_tp_serve_workers as W

CASES = ("serve", "features", "skew")
CFG = dict(initializer_range=0.3)
NEW = 6


def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining, gpt_tiny
    paddle.seed(0)
    return GPTForPretraining(gpt_tiny(**CFG))


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


def _lora_weights():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 4, 64).astype(np.float32) * 0.5,
            rng.randn(2, 4, 192).astype(np.float32) * 0.5)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_model):
    out = tmp_path_factory.mktemp("tp_serve_world")
    inputs = {"cfg": CFG, "lora": _lora_weights(),
              "weights": {k: np.asarray(v._data)
                          for k, v in jax_model.state_dict().items()}}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_tp_serve_workers:run", args=(str(out), CASES),
          nprocs=W.N)
    ranks = []
    for r in range(W.N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _case(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


def _jax_engine(model, mesh=False, quant="", **kw):
    import jax
    from paddle_tpu.core.flags import flag_scope
    from paddle_tpu.distributed.spmd import make_mesh
    from paddle_tpu.serving import ServingConfig, ServingEngine
    cfg = dict(W.ENGINE)
    cfg.update(kw)
    if mesh:
        cfg["mesh"] = make_mesh({"mp": 2}, jax.devices()[:2])
    with flag_scope("serve_kv_quant", quant):
        return ServingEngine(model, ServingConfig(**cfg))


def _golden(model, prompt, n):
    """The JAX model's greedy continuation, one whole forward a token."""
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import no_grad
    seq = np.asarray(prompt, np.int32)
    for _ in range(n):
        with no_grad():
            lg = model(paddle.to_tensor(seq[None, :])).numpy()
        seq = np.concatenate([seq, [np.int32(lg[0, -1].argmax())]])
    return seq.tolist()


@pytest.mark.parametrize("quant", ["", "int8"])
def test_tp_engine_tokens_equal_the_jax_engines(world, jax_model, quant):
    """f32 and int8 pools: each rank's greedy tokens for the three
    prompts equal the JAX engine's, without a mesh and on the JAX
    ``{"mp": 2}`` mesh, exactly."""
    want = []
    for mesh in (False, True):
        eng = _jax_engine(jax_model, mesh, quant)
        want.append([o.tolist() for o in eng.generate(
            W.PROMPTS, max_new_tokens=NEW)])
        eng.shutdown()
    assert want[0] == want[1]
    for r in _case(world, "serve"):
        assert r[quant or "f32"]["tokens"] == want[0]


def test_each_rank_holds_half_the_heads(world):
    """The pools hold H/2 = 2 of gpt_tiny's 4 heads a rank (rank r from
    head 2r), int8 scale pools too, so a rank's K/V bytes are half of
    one process's; the fused QKV weight keeps the rank's heads."""
    L, P, bs, H, D = 2, 1 + 3 * 16, 4, 4, 16
    for rank, r in enumerate(_case(world, "serve")):
        f32, q8 = r["f32"], r["int8"]
        assert f32["k"] == (L, P, bs, H // 2, D) == q8["k"]
        assert f32["head_block"] == (2 * rank, 2, 4) == q8["head_block"]
        assert q8["k_scale"] == (L, P, bs, H // 2)
        assert f32["kv_bytes"] * 2 == 2 * L * P * bs * H * D * 4
        assert q8["kv_bytes"] * 2 == 2 * L * P * bs * H * (D + 4)
        assert f32["qkv_weight"] == (64, 3, 2, 16)
        # one boundary message a step and one token message a dispatch
        assert f32["messages"] > 0


def test_lora_on_mp_equals_the_jax_mesh_engine(world, jax_model):
    """An adapter loaded whole into each rank's manager (its ``b`` pool
    keeps the rank's 3 x 2 x 16 QKV columns) gives the JAX mesh engine's
    tokens for the adapter's request and the base request beside it."""
    from paddle_tpu.serving import Request
    eng = _jax_engine(jax_model, True, lora_adapters=2, lora_rank=4)
    eng.lora.load_adapter("x", weights=_lora_weights())
    sts = [eng.submit(Request(p, max_new_tokens=NEW, adapter=a))
           for p, a in ((W.REP_PROMPT, "x"), (W.PROMPTS[1], None))]
    eng.run()
    want = [list(map(int, st.generated)) for st in sts]
    eng.shutdown()
    for r in _case(world, "serve"):
        assert r["lora"]["tokens"] == want
        assert r["lora"]["b"] == (2, 3, 4, 96) and r["lora"]["refs"] == 0


def test_spec_prefix_chunks_and_generate_equal_the_greedy_oracle(
        world, jax_model):
    """Speculative decoding at k = 3 (drafts proposed and verified), the
    prefix cache (a hit on the second prompt) with 4-token chunks, and
    ``generate`` over static caches of the rank's heads: tokens equal
    the JAX model's greedy oracle."""
    spec = _golden(jax_model, W.REP_PROMPT, 8)
    shared = [_golden(jax_model, p, NEW) for p in W.SHARED]
    gen = _golden(jax_model, W.REP_PROMPT, NEW)
    for r, s in zip(_case(world, "features"), _case(world, "serve")):
        assert r["spec"] == [spec]
        assert r["spec_proposed"] > 0 and r["verify"] > 0
        assert r["shared"] == shared
        assert r["prefix_hits"] >= 1 and r["context"] > 0
        assert r["chunks"] > 0
        assert s["generate"] == [gen]


def test_skewed_clocks_keep_the_ranks_in_lockstep(world, jax_model):
    """Deadlines of 60 s, a blown one, a cancel latched in flight and a
    pool of 8 pages that preempts: with rank 1's clock 1e4 s ahead and
    1000x fast the ranks give the tokens and outcomes of the unskewed
    run (rank 0 decides), and the completed requests' tokens are the
    greedy oracle's. A lockstep message larger than its one-broadcast
    head arrives whole."""
    res = _case(world, "skew")
    plain = res[0]["plain"]
    assert plain["outcomes"] == ["completed", "cancelled", "completed",
                                 "expired", "completed"]
    assert plain["preemptions"] > 0
    for r in res:
        for run in (r["plain"], r["skewed"]):
            assert run.pop("big") == list(range(3000))
            assert run["outcomes"] == plain["outcomes"]
            assert run["tokens"] == plain["tokens"]
            assert run["stats"] == plain["stats"]
    for i in (0, 2):
        want = _golden(jax_model, W.PROMPTS[i], NEW)
        assert W.PROMPTS[i] + plain["tokens"][i] == want


def _fake_mesh(mp, coord, axis="mp"):
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.distributed.spmd import Mesh
    return Mesh({axis: mp}, {axis: Group(list(range(mp)), -1, axis)},
                (coord,))


def test_indivisible_heads_raise_at_construction():
    """mp = 3 on gpt_tiny's 4 heads raises ``ValueError`` naming
    ``num_heads`` when the engine is built, as in JAX."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        ServingEngine(m, ServingConfig(mesh=_fake_mesh(3, 0), **W.ENGINE),
                      device="cpu")


@pytest.mark.parametrize("quant", ["", "int8"])
def test_shard_serving_cache_cuts_the_jax_layout(quant):
    """``shard_serving_cache`` keeps rank r's heads ``[2r, 2r + 2)`` of a
    whole cache's pools (and scales), the block ``SERVE_KV_SPEC`` gives
    rank r of the JAX mesh; a mesh without mp leaves the pools whole;
    a second call changes nothing."""
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.distributed.spmd import (SERVE_KV_SPEC,
                                                   shard_serving_cache)
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache
    from paddle_tpu.distributed.spmd import SERVE_KV_SPEC as JAX_SPEC
    assert tuple(SERVE_KV_SPEC) == tuple(JAX_SPEC)

    def cache():
        with flag_scope("serve_kv_quant", quant):
            c = PagedKVCache(2, 4, 16, num_pages=5, block_size=4,
                             max_slots=2, max_blocks_per_slot=2,
                             device="cpu")
        for t in (c.k, c.v, c.k_scale, c.v_scale):
            if t is not None:
                t.copy_(torch.arange(t.numel()).reshape(t.shape))
        return c
    full = cache()
    for r in range(2):
        c = shard_serving_cache(cache(), _fake_mesh(2, r))
        assert c.num_heads == 2 and c.head_block == (2 * r, 2, 4)
        for name in ("k", "v", "k_scale", "v_scale"):
            whole, cut = getattr(full, name), getattr(c, name)
            if whole is None:
                assert cut is None
                continue
            assert torch.equal(cut, whole[:, :, :, 2 * r:2 * r + 2])
        k = c.k
        assert shard_serving_cache(c, _fake_mesh(2, r)).k is k
    c = shard_serving_cache(cache(), _fake_mesh(2, 1, axis="dp"))
    assert c.num_heads == 4 and torch.equal(c.k, full.k)
