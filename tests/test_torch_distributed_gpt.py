"""The port's data- and tensor-parallel GPT training against the JAX
package, on a CPU gloo world of four ranks.

One world serves the whole file (``_torch_dist_workers``: every case in
one spawn, results pickled back): ``gpt_tiny`` laid on mp = 4 and on dp
= 2 x mp = 2 gives the JAX dense model's logits; a dp = 2 x mp = 2
ZeRO-1 ``TrainStep`` with the global-norm clip equals the JAX
single-device ``TrainStep`` for 3 steps; with dropout 0.1 it equals the
port's single-process step from the same seed (the kernels' base
offsets); ``grad_accum_steps=2`` equals one step on the doubled batch;
a loss mask uneven over the dp ranks gives the JAX step's global masked
mean; the clip's norm is the unsharded one; the vocab-parallel loss and
its gradient are JAX's dense ``ParallelCrossEntropy``. The dropout offsets
are also held here on the CPU against the plain versions of the whole
tensors, and on the card (``cuda``) against the kernels' whole
launches, bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn_mod import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.optimizer import AdamW

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
CASES = ("tp_logits", "train_jax", "train_sharding", "train_dropout",
         "accum", "masked", "clip_norm", "vocab_ce", "mp_layers")
B, S = 4, 16


def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    paddle.seed(0)
    return JaxGPT(jax_gpt_tiny(**CFG, initializer_range=0.2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("gpt_world")
    jm = _jax_model()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    other = (rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32),
             rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32))
    ce = (rng.randn(2, 8, 32).astype(np.float32) * 3.0,
          rng.randint(0, 32, (2, 8)).astype(np.int64))
    # dp rank 0's rows keep 30 positions, rank 1's keep 5
    mask = np.zeros((B, S), np.float32)
    mask[0, :] = 1.0
    mask[1, :14] = 1.0
    mask[2, 3:6] = 1.0
    mask[3, 9:11] = 1.0
    inputs = {"cfg": dict(CFG, initializer_range=0.2),
              "weights": {k: np.asarray(v._data)
                          for k, v in jm.state_dict().items()},
              "ids": ids, "batch": (ids, labels),
              "halves": [(ids, labels), other], "ce": ce,
              "masked": (ids, labels, mask)}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_dist_workers:run", args=(str(out), CASES), nprocs=4)
    ranks = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return jm, inputs, ranks


def _case(world, name):
    res = [r[name] for r in world[2]]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


def _port_step(inputs, **cfg_over):
    model = load_jax_weights(GPTForPretraining(
        gpt_tiny(**dict(inputs["cfg"], **cfg_over)), device="cpu"),
        inputs["weights"])
    crit = GPTPretrainingCriterion()
    return TrainStep(model, lambda layer, i, t: crit(layer(i), t),
                     AdamW(1e-4, parameters=model.parameters(),
                           weight_decay=0.01), seed=0)


def test_tp_logits_match_the_jax_dense_model(world):
    """mp = 4 (one head a rank, through ``fleet.distributed_model``'s
    ``TensorParallel``, whose state-dict names are the model's) and dp =
    2 x mp = 2 (each dp rank its two rows), logits gathered over mp:
    rtol/atol 2e-4, as ``test_gpt_tp_parity_vs_dense``."""
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    jm, inputs, _ = world
    with paddle.no_grad():
        gold = jm(Tensor(inputs["ids"])).numpy()
    res = _case(world, "tp_logits")
    assert all(r["wrapper"] == ("TensorParallel", True) for r in res)
    for layout, heads in (((1, 4), 1), ((2, 2), 2)):
        for r in res:
            got = r[layout]
            assert got["qkv_shape"] == (32, 3, heads, 8)
            b = B // layout[0]
            d = got["dp_rank"]
            np.testing.assert_allclose(got["logits"], gold[d * b:(d + 1) * b],
                                       rtol=2e-4, atol=2e-4)


def _jax_clipped_losses(world):
    """The JAX single-device TrainStep with ``ClipGradByGlobalNorm(0.5)``:
    3 losses and its parameters."""
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm as JaxClip
    _, inputs, _ = world
    jm = _jax_model()
    jcrit = JaxCrit()
    jstep = JaxTrainStep(jm, lambda layer, i, t: jcrit(layer(i), t),
                         JaxAdamW(learning_rate=1e-4,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01,
                                  grad_clip=JaxClip(0.5)))
    return [float(jstep(*inputs["batch"])) for _ in range(3)], jstep.params


def test_dp_mp_zero1_trainstep_matches_the_jax_trainstep(world):
    """dp = 2 x mp = 2 with ZeRO-1 over dp and ``ClipGradByGlobalNorm
    (0.5)`` (binding here) against the JAX single-device TrainStep with
    the same clip, 3 steps: losses within 1e-4 and every gathered
    parameter within 1e-5, as ``test_trainstep_f32_matches_jax_trainstep``.
    The slots of ``w_in [32, 128]`` hold (16, 64): mp cuts the columns,
    ZeRO the rows. The saved file is the single-process format."""
    from paddle_tpu_torch.framework.io import load
    _, inputs, _ = world
    jl, jparams = _jax_clipped_losses(world)
    res = _case(world, "train_jax")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, atol=1e-4, rtol=0)
        assert r["w_in"] == (32, 64) and r["w_in_slot"] == (16, 64)
    assert res[0]["losses"][2] < res[0]["losses"][0]
    params = res[0]["params"]
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k], np.asarray(v), atol=1e-5,
                                   rtol=0, err_msg=k)
    saved = load(res[0]["path"])
    single = _port_step(inputs).state_dict()
    assert set(saved["params"]) == set(single["params"])
    assert res[0]["opt_keys"] == sorted(single["opt_state"])
    for k, v in single["opt_state"].items():
        if isinstance(v, np.ndarray):
            assert saved["opt_state"][k].shape == v.shape, k
    for k, v in params.items():
        np.testing.assert_array_equal(saved["params"][k], v, err_msg=k)


def test_dp_sharding_zero1_trainstep_matches_the_jax_trainstep(world):
    """dp = 2 x sharding = 2 through ``ShardingParallel``: the batch over
    both axes, ZeRO-1 over sharding (w_in's slots (16, 128)), the clip at
    0.5: the JAX single-device step's losses (1e-4) and parameters
    (1e-5) over 3 steps."""
    jl, jparams = _jax_clipped_losses(world)
    res = _case(world, "train_sharding")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, atol=1e-4, rtol=0)
        assert r["mode"] == "ShardingParallel"
        assert r["w_in_slot"] == (16, 128)
    for k, v in jparams.items():
        np.testing.assert_allclose(res[0]["params"][k], np.asarray(v),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_mp_layers_match_their_dense_products(world):
    """At mp = 4: ColumnParallelLinear (gathered, and split into a
    RowParallelLinear with ``input_is_parallel``), RowParallelLinear on
    the full input, VocabParallelEmbedding and ``split``: outputs and
    each rank's gradient blocks against the float64 dense products and
    gradients from the same full weights, within 1e-5 of the largest
    entry (float32 sums of at most 16 products: a few ulps)."""
    for r in _case(world, "mp_layers"):
        assert r["shapes"] == ((8, 4), (4, 8), (8, 8))
        for key in ("y", "z", "e", "split", "col_w", "col_b", "row_w",
                    "row_b", "emb_w"):
            assert r[key] <= 1e-5, (key, r[key])


def test_dp_mp_dropout_equals_the_single_process_step(world):
    """Dropout 0.1 (embedding, both residual branches, attention): every
    rank draws its batch rows' and heads' slice of the single-process
    masks, so the world's losses and parameters equal the port's
    single-process step from the same seed (1e-5 on losses and
    parameters: only the order of the mp and dp sums differs)."""
    _, inputs, _ = world
    step = _port_step(inputs, hidden_dropout_prob=0.1,
                      attention_dropout_prob=0.1)
    want = [float(step(*inputs["batch"])) for _ in range(3)]
    res = _case(world, "train_dropout")
    for r in res:
        np.testing.assert_allclose(r["losses"], want, atol=1e-5, rtol=0)
    nodrop = _port_step(inputs)
    assert abs(float(nodrop(*inputs["batch"])) - want[0]) > 1e-3
    sd = step.layer.state_dict()
    for k, v in res[0]["params"].items():
        np.testing.assert_allclose(v, sd[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_dp_masked_loss_is_the_global_batchs_masked_mean(world):
    """A loss mask that keeps 30 positions on dp rank 0's rows and 5 on
    rank 1's: the dp=2 x mp=2 step's loss is the global masked mean, not
    the mean of the ranks' own masked means, so its losses (1e-4) and
    parameters (1e-5) over 2 steps are the JAX single-device step's."""
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    _, inputs, _ = world
    jm = _jax_model()
    jcrit = JaxCrit()
    jstep = JaxTrainStep(jm, lambda layer, i, t, m: jcrit(layer(i), t, m),
                         JaxAdamW(learning_rate=1e-4,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01))
    jl = [float(jstep(*inputs["masked"])) for _ in range(2)]
    res = _case(world, "masked")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, atol=1e-4, rtol=0)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(res[0]["params"][k], np.asarray(v),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_grad_accum_equals_one_step_on_the_doubled_batch(world):
    """``grad_accum_steps=2`` on the world over batches A and B: one
    update, equal (1e-5) to a single-process step on concat(A, B); each
    call's loss is its batch's."""
    _, inputs, _ = world
    (a, la), (b, lb) = inputs["halves"]
    step = _port_step(inputs)
    step(np.concatenate([a, b]), np.concatenate([la, lb]))
    sd = step.layer.state_dict()
    first = float(_port_step(inputs)(a, la))
    res = _case(world, "accum")
    for r in res:
        assert r["steps"] == 1 and r["microsteps"] == 2
        np.testing.assert_allclose(r["losses"][0], first, atol=1e-5)
    for k, v in res[0]["params"].items():
        np.testing.assert_allclose(v, sd[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_gradient_merge_comes_from_the_strategy_snapshot():
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 3, "avg": False}
    model = GPTForPretraining(gpt_tiny(**CFG), device="cpu")
    opt = fleet.distributed_optimizer(
        AdamW(1e-4, parameters=model.parameters()), strategy)
    strategy.gradient_merge_configs = {"k_steps": 5}
    step = TrainStep(model, lambda layer, i, t: layer(i).sum(), opt)
    assert (step.grad_accum_steps, step.grad_accum_avg) == (3, False)
    bare = TrainStep(model, lambda layer, i, t: layer(i).sum(),
                     AdamW(1e-4, parameters=model.parameters()))
    assert bare.grad_accum_steps == 1


def test_clip_norm_counts_replicated_parameters_once(world):
    """mp = 4: the sharded gradients' squares summed over mp, the layer
    norms, biases and position embeddings counted once: the single
    process's norm within rtol 1e-5."""
    _, inputs, _ = world
    model = load_jax_weights(GPTForPretraining(gpt_tiny(**inputs["cfg"]),
                                               device="cpu"),
                             inputs["weights"])
    crit = GPTPretrainingCriterion()
    crit(model(torch.from_numpy(inputs["batch"][0])),
         torch.from_numpy(inputs["batch"][1])).backward()
    want = float(torch.sqrt(sum(torch.sum(p.grad ** 2)
                                for p in model.parameters())))
    for r in _case(world, "clip_norm"):
        assert r["n_sharded"] == 1 + 6 * CFG["num_layers"]
        np.testing.assert_allclose(r["norm"], want, rtol=1e-5)


def test_vocab_parallel_loss_matches_jax_parallel_cross_entropy(world):
    """Each rank's [2, 8, 8] block of [2, 8, 32] logits, the mp group
    given to the loss or marked on the block: the loss equals JAX's
    dense ``ParallelCrossEntropy`` (1e-5) and the rank's block of the
    mean loss's gradient equals JAX's (1e-6). Under the same mp = 4
    mesh the whole [2, 8, 32] logits give the dense loss (1e-5), and an
    unmarked block whose labels run past it is refused."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed.meta_parallel.parallel_layers.mp_layers \
        import ParallelCrossEntropy as JaxPCE
    _, inputs, _ = world
    logits, labels = inputs["ce"]
    ce = JaxPCE()
    loss = np.asarray(ce(Tensor(jnp.asarray(logits)),
                         Tensor(jnp.asarray(labels)))._data)

    def mean_loss(lg):
        return ce(Tensor(lg), Tensor(jnp.asarray(labels)))._data.mean()
    grad = np.asarray(jax.grad(mean_loss)(jnp.asarray(logits)))
    for r, got in enumerate(_case(world, "vocab_ce")):
        for how in ("given", "marked"):
            np.testing.assert_allclose(got[how]["loss"], loss, atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(got[how]["grad"],
                                       grad[..., r * 8:(r + 1) * 8],
                                       atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["whole"], loss, atol=1e-5, rtol=0)
        assert "mp_group=" in got["unmarked"]


# -- the dropout base offsets -------------------------------------------------
def _qkv(B_, S_, H, D, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(B_, S_, H, D, generator=g).to(device=device,
                                                      dtype=dtype)
            for _ in range(4)]


def test_offsets_slice_the_whole_masks_in_the_plain_versions():
    """A plain-version call on batch rows 2-3 and heads 2-3 with bases
    (2, 2) equals the whole call's slice, o, lse, dq, dk and dv bit for
    bit; the fused dropout's plain version from element base b0*S*E
    equals the whole tensor's slice; bases 0 are today's masks."""
    from paddle_tpu_torch.ops.kernels.dropout import dropout_plain
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    q, k, v, do = _qkv(4, 32, 4, 16)
    words = (1234, 5678)
    o, lse = flash_attention_fwd(q, k, v, True, None, True, 0.1, words)
    grads = flash_attention_bwd(q, k, v, o, lse, do, True, None, 0.1, words)
    sl = (slice(2, 4), slice(None), slice(2, 4))
    qs, ks, vs, dos = (t[sl].contiguous() for t in (q, k, v, do))
    os_, lses = flash_attention_fwd(qs, ks, vs, True, None, True, 0.1, words,
                                    batch_base=2, head_base=2)
    gs = flash_attention_bwd(qs, ks, vs, os_, lses, dos, True, None, 0.1,
                             words, batch_base=2, head_base=2)
    assert torch.equal(os_, o[sl]) and torch.equal(lses, lse[2:4, 2:4])
    for got, want in zip(gs, grads):
        assert torch.equal(got, want[sl])
    moved = flash_attention_fwd(qs, ks, vs, True, None, False, 0.1, words)
    assert not torch.equal(moved, o[sl])
    x = torch.randn(4, 8, 32)
    whole = dropout_plain(x, 0.1, words)
    assert torch.equal(dropout_plain(x[2:], 0.1, words, base=2 * 8 * 32),
                       whole[2:])
    assert not torch.equal(dropout_plain(x[2:], 0.1, words), whole[2:])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_offset_launches_equal_the_whole_launches_slices(cuda, dtype):
    """On the card, at [4, 256, 16, 64]: rows 1 and 3 launched on batch
    rows 2-3 and heads 8-15 with bases (2, 8) give the whole launches'
    slices bit for bit (o, lse, dq, dk, dv); row 8 from element base
    2*256*1024 gives the whole launch's rows; both hold their plain
    versions (bf16: within 2**-7 of the largest entry)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.dropout import (dropout_apply,
                                                      dropout_plain)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_plain)
    kernels.build()
    q, k, v, do = _qkv(4, 256, 16, 64, dtype, cuda)
    words = (77, 99)
    o, lse = flash_attention_fwd(q, k, v, True, None, True, 0.1, words)
    grads = flash_attention_bwd(q, k, v, o, lse, do, True, None, 0.1, words)
    sl = (slice(2, 4), slice(None), slice(8, 16))
    qs, ks, vs, dos = (t[sl].contiguous() for t in (q, k, v, do))
    os_, lses = flash_attention_fwd(qs, ks, vs, True, None, True, 0.1, words,
                                    batch_base=2, head_base=8)
    gs = flash_attention_bwd(qs, ks, vs, os_, lses, dos, True, None, 0.1,
                             words, batch_base=2, head_base=8)
    assert torch.equal(os_, o[sl]) and torch.equal(lses, lse[2:4, 8:16])
    for got, want in zip(gs, grads):
        assert torch.equal(got, want[sl])
    ref = flash_attention_plain(qs.cpu(), ks.cpu(), vs.cpu(), True, None,
                                False, 0.1, words, batch_base=2, head_base=8,
                                mxu_dtype=dtype)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    err = (os_.float().cpu() - ref.float()).abs().max()
    assert err <= tol * max(1.0, ref.float().abs().max()), err
    x = torch.randn(4, 256, 1024, device=cuda, dtype=dtype)
    whole = dropout_apply(x, 0.1, words)
    base = 2 * 256 * 1024
    part = dropout_apply(x[2:].contiguous(), 0.1, words, base)
    assert torch.equal(part, whole[2:])
    assert torch.equal(part.cpu(), dropout_plain(x[2:].cpu(), 0.1, words,
                                                 base))
