"""The port's MoE GPT against the JAX package's, on the CPU.

``GPTConfig``'s ``moe_*`` fields and ``GPTMoEDecoderLayer``: losses and
two ``TrainStep`` steps at ``moe_every`` 1 and 2, the O1 stream dtypes
(the JAX model scans a homogeneous stack, whose carry keeps the stream's
dtype, and loops over a mixed one, which casts nothing), state-dict
names both ways, a ``CheckpointManager`` resume, static-cache decode and
serving against the full forward, and the JAX ``monitor_report --moe``
rendering the port's registry dump. Each docstring states its
tolerance.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.incubate.moe import reset_moe_stats
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.models.gpt import GPTMoEDecoderLayer
from paddle_tpu_torch.optimizer import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _moe_isolation():
    reset_moe_stats()
    yield
    reset_moe_stats()


def _cfg(**kw):
    d = dict(num_layers=4, moe_experts=4, hidden_size=64, num_heads=4,
             vocab_size=256)
    d.update(kw)
    return d


def _batch(B=4, S=32, V=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, S)).astype(np.int32))


def _jax_model(kw, seed=1):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_tiny
    paddle.seed(seed)
    return JaxGPT(jax_tiny(**kw))


def _arrays(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _port_model(kw, jm):
    return load_jax_weights(GPTForPretraining(gpt_tiny(**kw), device="cpu"),
                            _arrays(jm))


def _loss_fn(crit, amp):
    def loss_fn(layer, ids, labels):
        with auto_cast(level="O1", enable=amp):
            return crit(layer(ids), labels) + layer.moe_loss()
    return loss_fn


def _jax_loss_fn(amp):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    crit = JaxCrit()

    def loss_fn(layer, ids, labels):
        with paddle.amp.auto_cast(level="O1", enable=amp):
            return crit(layer(ids), labels) + layer.moe_loss()
    return loss_fn


def test_moe_layer_indices_match_jax():
    """Which layers carry experts, for the JAX configs' cases."""
    from paddle_tpu.models.gpt import gpt_tiny as jax_tiny
    for kw in (dict(num_layers=4), dict(num_layers=4, moe_experts=4),
               dict(num_layers=6, moe_experts=4, moe_every=2),
               dict(num_layers=6, moe_experts=4, moe_every=3)):
        assert gpt_tiny(**kw).moe_layer_indices() == \
            jax_tiny(**kw).moe_layer_indices()
    with pytest.raises(ValueError, match="places no MoE layer"):
        GPTForPretraining(gpt_tiny(num_layers=2, moe_experts=4, moe_every=3),
                          device="cpu")


@pytest.mark.parametrize("every", [1, 2])
def test_moe_trainstep_matches_jax(every):
    """``moe_every`` 1 (all four layers MoE) and 2 (layers 1 and 3), f32,
    ``crit + moe_loss`` under AdamW 1e-4 (decay 0.01): the first loss
    and two ``TrainStep`` steps' losses within 1e-5, the router vectors
    of the first forward within 1e-5 (the stats exactly but the
    entropy), every parameter after the steps within 1e-5 (the key bias,
    0 gradient in exact arithmetic, within ``2 * lr * steps``)."""
    import paddle_tpu as paddle
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    kw = _cfg(moe_every=every)
    jm = _jax_model(kw)
    tm = _port_model(kw, jm)
    ids, labels = _batch()
    with paddle.no_grad():
        jl0 = float(_jax_loss_fn(False)(jm, paddle.to_tensor(ids),
                                        paddle.to_tensor(labels)))
    jvec = np.asarray(jm.gpt.moe_layer_stats()._data)
    with torch.no_grad():
        tl0 = float(_loss_fn(GPTPretrainingCriterion(), False)(
            tm, torch.from_numpy(ids).long(), torch.from_numpy(labels)
            .long()))
    tvec = tm.gpt.moe_layer_stats().numpy()
    assert tvec.shape == (4 // every, 5 + 4)
    np.testing.assert_allclose(tl0, jl0, rtol=1e-5)
    np.testing.assert_allclose(tvec, jvec, rtol=1e-5, atol=1e-6)
    jstep = JaxTrainStep(jm, _jax_loss_fn(False), JaxAdamW(
        learning_rate=1e-4, parameters=jm.parameters(), weight_decay=0.01))
    tstep = TrainStep(tm, _loss_fn(GPTPretrainingCriterion(), False), AdamW(
        1e-4, parameters=tm.parameters(), weight_decay=0.01))
    jls = [float(jstep(ids, labels)) for _ in range(2)]
    tls = [float(tstep(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(tls, jls, rtol=0, atol=1e-5)
    assert tls[1] < tls[0]
    got = tstep.state_dict()["params"]
    for k, v in jstep.params.items():
        v, g = np.asarray(v), got[k]
        if k.endswith("qkv_bias"):
            np.testing.assert_allclose(g[1], v[1], atol=2 * 1e-4 * 2)
            g, v = g[0::2], v[0::2]
        np.testing.assert_allclose(g, v, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("every", [1, 2])
def test_o1_stream_dtype_follows_the_jax_scan(every):
    """Under O1 the embedding starts the stream in bf16 and the expert
    FFN returns f32 (promotion). ``moe_every=1`` is homogeneous: the JAX
    model scans it and its carry casts each block's output back to bf16,
    so the hidden states are bf16; ``moe_every=2`` mixes dense and MoE
    blocks: the JAX loop casts nothing, so the stream stays f32 from the
    first block's f32 MLP bias on. The port's hidden states take JAX's
    dtype in both, and its loss is within 2e-3 relative of JAX's (bf16
    roundings at other points)."""
    import paddle_tpu as paddle
    kw = _cfg(moe_every=every)
    jm = _jax_model(kw)
    tm = _port_model(kw, jm)
    ids, labels = _batch()
    with paddle.no_grad(), paddle.amp.auto_cast(level="O1"):
        jh = jm.gpt(paddle.to_tensor(ids))
        jl = float(_jax_loss_fn(True)(jm, paddle.to_tensor(ids),
                                      paddle.to_tensor(labels)))
    with torch.no_grad(), auto_cast(level="O1"):
        th = tm.gpt(torch.from_numpy(ids).long())
        tl = float(_loss_fn(GPTPretrainingCriterion(), True)(
            tm, torch.from_numpy(ids).long(),
            torch.from_numpy(labels).long()))
    want = {1: torch.bfloat16, 2: torch.float32}[every]
    assert str(jh._data.dtype) == str(want).replace("torch.", "")
    assert th.dtype == want
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    dense = gpt_tiny(**_cfg(moe_experts=0))
    with torch.no_grad(), auto_cast(level="O1"):
        h = GPTForPretraining(dense, device="cpu").gpt(
            torch.from_numpy(ids).long())
    assert h.dtype == torch.bfloat16        # a dense stack scans in JAX


def test_state_dict_names_both_ways():
    """The port's state-dict names are the JAX model's (dense layers keep
    ``mlp.*``, MoE layers add ``moe.gate.weight`` and ``moe.experts.*``);
    the port's arrays loaded into a JAX model give the port's logits
    within 1e-5, and back into a fresh port model bit for bit."""
    import paddle_tpu as paddle
    kw = _cfg(moe_every=2)
    jm = _jax_model(kw, seed=2)
    tm = GPTForPretraining(gpt_tiny(**kw), device="cpu", seed=3)
    names = set(tm.state_dict())
    assert names == set(jm.state_dict())
    assert "gpt.layers.0.mlp.w_in" in names
    assert "gpt.layers.1.moe.experts.w1" in names
    assert "gpt.layers.3.moe.gate.weight" in names
    assert "gpt.layers.1.mlp.w_in" not in names
    assert isinstance(tm.gpt.layers[1], GPTMoEDecoderLayer)
    arrays = {k: v.numpy() for k, v in tm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    ids, _ = _batch(B=2, S=16)
    tm.eval()
    with torch.no_grad():
        ref = tm(torch.from_numpy(ids).long()).numpy()
    with paddle.no_grad():
        got = np.asarray(jm(paddle.to_tensor(ids))._data)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    fresh = load_jax_weights(GPTForPretraining(gpt_tiny(**kw), device="cpu",
                                               seed=9), _arrays(jm))
    fresh.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(
            fresh(torch.from_numpy(ids).long()).numpy(), ref)


def test_checkpoint_manager_resume_bit_exact(tmp_path):
    """A ``CheckpointManager`` resume of an MoE GPT (every 2 steps, 4
    steps, then a fresh step resumes at 4 and runs 2) repeats six
    uninterrupted steps' losses bit for bit."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    kw = _cfg(num_layers=2)
    ids, labels = _batch(B=2, S=16)
    root = str(tmp_path / "ckpts")

    def build(seed):
        m = GPTForPretraining(gpt_tiny(**kw), device="cpu", seed=seed)
        return TrainStep(m, _loss_fn(GPTPretrainingCriterion(), False),
                         AdamW(1e-3, parameters=m.parameters()), seed=5)
    ref_step = build(5)
    ref = [float(ref_step(ids, labels)) for _ in range(6)]
    a = build(5)
    with CheckpointManager(a, root, interval_steps=2, keep_n=2) as mgr:
        got = []
        for i in range(4):
            got.append(float(a(ids, labels)))
            mgr.on_step(dataloader_state={"offset": i + 1})
    assert got == ref[:4]
    b = build(6)
    with CheckpointManager(b, root, interval_steps=2, keep_n=2) as mgr:
        assert mgr.resume()["step"] == 4
        assert [float(b(ids, labels)) for _ in range(2)] == ref[4:]


def test_static_cache_decode_matches_the_full_forward():
    """At capacity factor E (no drops whatever the tokens routed
    together), ``generate`` greedy over the static cache picks the full
    forward's argmax token for token (the JAX test's check), and the
    JAX model's ``generate`` gives the same tokens."""
    import paddle_tpu as paddle
    kw = _cfg(num_layers=2, moe_capacity_factor=4.0, initializer_range=0.3)
    jm = _jax_model(kw, seed=6)
    jm.eval()
    tm = _port_model(kw, jm)
    tm.eval()
    prompt = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(
        np.int32)
    got = tm.generate(prompt, max_new_tokens=6,
                      decode_strategy="greedy_search").numpy()
    cur = prompt.astype(np.int64)
    with torch.no_grad():
        for _ in range(6):
            logits = tm(torch.from_numpy(cur))
            nxt = logits[:, -1].argmax(-1).numpy()[:, None]
            cur = np.concatenate([cur, nxt], axis=1)
    np.testing.assert_array_equal(got, cur)
    with paddle.no_grad():
        jout = jm.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                           decode_strategy="greedy_search")
    jout = np.asarray(jout._data if hasattr(jout, "_data") else jout)
    np.testing.assert_array_equal(got, jout[:, :got.shape[1]])


def test_serving_engine_serves_the_moe_gpt():
    """The paged path: ``ServingEngine`` over the MoE GPT (capacity
    factor E, greedy; prompts padded to one prefill bucket, whose pad
    tokens route too but take no capacity from the others) gives each
    request ``generate``'s tokens."""
    from paddle_tpu_torch.serving import (Request, SamplingParams,
                                          ServingConfig, ServingEngine)
    kw = _cfg(num_layers=2, moe_capacity_factor=4.0, initializer_range=0.3)
    tm = _port_model(kw, _jax_model(kw, seed=7))
    tm.eval()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 11, 8)]
    eng = ServingEngine(tm, ServingConfig(
        max_batch_slots=4, block_size=8, max_context_len=64,
        prefill_buckets=(16,), batch_buckets=(1, 2, 4)), device="cpu")
    reqs = [eng.submit(Request(p, max_new_tokens=5,
                               sampling=SamplingParams())) for p in prompts]
    eng.run()
    for p, r in zip(prompts, reqs):
        want = tm.generate(np.asarray([p]), max_new_tokens=5,
                           decode_strategy="greedy_search").numpy()[0]
        assert r.outcome == "completed"
        assert list(r.generated) == want[len(p):].tolist()


def test_mixed_stack_side_outputs_and_monitor_report(tmp_path):
    """``moe_every=2``: the loop collects layers 1 and 3's vectors,
    ``moe_loss`` is their weighted aux + z, and the JAX
    ``tools/monitor_report.py --moe`` renders the port's registry dump
    (per-layer drop, balance and entropy)."""
    from paddle_tpu.monitor import load_jsonl
    from paddle_tpu_torch.monitor import scoped_registry
    kw = _cfg(moe_every=2)
    tm = GPTForPretraining(gpt_tiny(**kw), device="cpu", seed=4)
    ids, _ = _batch(B=2, S=16)
    with torch.no_grad():
        tm(torch.from_numpy(ids).long())
    v = tm.gpt.moe_layer_stats()
    assert tuple(v.shape) == (2, 5 + 4)
    np.testing.assert_allclose(
        float(tm.moe_loss()), float(1e-2 * v[:, 0].sum()
                                    + 1e-3 * v[:, 1].sum()), rtol=1e-6)
    path = str(tmp_path / "mon.jsonl")
    with scoped_registry() as reg:
        assert tm.gpt.publish_moe_telemetry() == 2
        g = reg.get("moe_router_balance_pct")
        assert {dict(lbl)["layer"] for lbl, _ in g.samples()} == \
            {"layer1", "layer3"}
        reg.dump_jsonl(path)
    spec = importlib.util.spec_from_file_location(
        "monitor_report", os.path.join(ROOT, "tools", "monitor_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = mod.render(load_jsonl(path), moe=True)
    assert "MoE router health" in text
    assert "layer1" in text and "layer3" in text
    assert "balance%" in text and "drop%" in text


def test_pipeline_model_refuses_moe():
    """``GPTForPretrainingPipe`` builds dense stages: an MoE config
    raises, as in the JAX package."""
    from paddle_tpu_torch.models import GPTForPretrainingPipe
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTForPretrainingPipe(gpt_tiny(**_cfg()), device="cpu")


# -- the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# head dim 64 (the flash kernels'), a vocabulary over the chunked-CE
# threshold, dropout 0.1: every training kernel of phase 23 (a)
CARD_CFG = dict(num_layers=4, moe_experts=4, moe_every=2, hidden_size=128,
                num_heads=2, vocab_size=4352, max_position_embeddings=256,
                hidden_dropout_prob=0.1, attention_dropout_prob=0.1)


@pytest.mark.cuda
def test_moe_trainstep_on_card_launches_the_dense_formula(cuda):
    """Three O1 steps of a 4-layer MoE GPT (experts in layers 1 and 3)
    with dropout on the card: the loss falls and rows 1, 3, 6, 7 and 8
    launch exactly what the dense step launches (L a step each for the
    flash kernels, one a step for the CE kernels, 2 * (1 + 2L) dropouts
    a step): the MoE layer launches no kernel of its own."""
    from paddle_tpu_torch.ops import kernels
    m = GPTForPretraining(gpt_tiny(**CARD_CFG), device=cuda, seed=0)
    step = TrainStep(m, _loss_fn(GPTPretrainingCriterion(), True),
                     AdamW(1e-3, parameters=m.parameters()), seed=0)
    ids, labels = _batch(B=4, S=128, V=CARD_CFG["vocab_size"])
    kernels.reset_launch_counts()
    losses = [float(step(ids, labels)) for _ in range(3)]
    got = {k["name"]: k["launches"] for k in kernels.kernels()}
    L, n = CARD_CFG["num_layers"], 3
    want = {name: 0 for name in got}
    want.update(flash_attention_fwd=L * n, flash_attention_bwd=L * n,
                chunked_ce_lse=n, chunked_ce_dlogits=n,
                fused_dropout=2 * (1 + 2 * L) * n)
    assert got == want
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_moe_decode_on_card_matches_the_full_forward(cuda):
    """At capacity factor E on the card: ``generate`` greedy picks the
    full forward's argmax token for token, through the flash prefill and
    the paged-decode kernel (row 1 once a layer, row 9 once a layer a
    step)."""
    from paddle_tpu_torch.ops import kernels
    kw = dict(CARD_CFG, moe_capacity_factor=4.0, initializer_range=0.3)
    m = GPTForPretraining(gpt_tiny(**kw), device=cuda, seed=2)
    m.eval()
    prompt = np.random.default_rng(4).integers(0, kw["vocab_size"],
                                               (2, 16)).astype(np.int32)
    kernels.reset_launch_counts()
    got = m.generate(prompt, max_new_tokens=8,
                     decode_strategy="greedy_search").cpu().numpy()
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    L = kw["num_layers"]
    assert launches["flash_attention_fwd"] == L
    assert launches["paged_decode_attention"] == L * 7
    with torch.no_grad():
        logits = m(torch.from_numpy(got[:, :-1].astype(np.int64)).to(cuda))
    pred = logits[:, 15:].argmax(-1).cpu().numpy()
    np.testing.assert_array_equal(pred, got[:, 16:])
