"""The port's tensor-parallel encoder (BERT and ERNIE through
``apply_hybrid_specs``) against the JAX package, on a CPU gloo world of
four ranks: BASELINE config 5's recipe at toy widths.

One world serves the file (``_torch_p2b_workers``): ``ernie_tiny`` (D =
16) stamped by ``apply_hybrid_specs`` at sharding = 2 x mp = 2, ZeRO
over sharding, trains as the JAX single-device step from the same
weights (f32 within 1e-5; under O1 within the dryrun leg C's
``rtol=1e-2``); the stamped blocks have the shapes the JAX
``test_hybrid_tp_zero_on_mesh`` asserts; at dropout 0.1 a model built
with ``mesh=`` (each rank's blocks only) trains as the port's
single-process step (1e-5); the replicated ``decoder_bias`` gets the
same whole gradient on every mp rank; a model without stamped specs
stays replicated; a step at sp = 2 x mp = 2 is refused. Rows 2, 4 and
5's plain versions with batch and head bases equal slices of the whole
launch bit for bit.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_ernie_hybrid.py``.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn_mod import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import ErnieForPretraining, ernie_tiny
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain)
from paddle_tpu_torch.optimizer import AdamW

N = 4
CASES = ("ernie_hybrid",)
CFG = dict(vocab_size=512, hidden_size=64, num_heads=4,
           intermediate_size=128, num_layers=2, max_position_embeddings=64)
B, S, M = 8, 32, 4
LR = 1e-4


def _batch():
    """A padded MLM batch: rows 3 and 6 shorter, ``M`` masked positions
    a row, SOP labels."""
    rng = np.random.RandomState(4)
    ids = rng.randint(5, CFG["vocab_size"], (B, S)).astype(np.int32)
    tt = np.zeros((B, S), np.int32)
    tt[:, S // 2:] = 1
    mask = np.ones((B, S), np.int32)
    mask[3, 20:] = 0
    mask[6, 12:] = 0
    pos = np.stack([rng.choice(10, M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    labels = rng.randint(5, CFG["vocab_size"], (B, M)).astype(np.int32)
    w = np.ones((B, M), np.float32)
    w[6, 3] = 0.0
    sop = rng.randint(0, 2, (B,)).astype(np.int32)
    return ids, tt, mask, pos, labels, w, sop


def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.ernie import ErnieForPretraining as JaxErnie
    from paddle_tpu.models.ernie import ernie_tiny as jax_ernie_tiny
    paddle.seed(3)
    return JaxErnie(jax_ernie_tiny(**CFG))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("ernie_world")
    jm = _jax_model()
    inputs = {"ernie_cfg": CFG, "ernie_batch": _batch(),
              "ernie_weights": {k: np.asarray(v._data)
                                for k, v in jm.state_dict().items()}}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_p2b_workers:run", args=(str(out), CASES), nprocs=N)
    ranks = []
    for r in range(N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for r in ranks:
        res = r["ernie_hybrid"]
        assert not (isinstance(res, str) and res.startswith("FAILED")), res
    return inputs, [r["ernie_hybrid"] for r in ranks]


def _jax_steps(amp: bool):
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    jm = _jax_model()

    def loss(layer, ids, tt, mask, pos, labels, w, sop):
        if amp:
            with paddle.amp.auto_cast(level="O1"):
                return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
        return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
    jstep = JaxTrainStep(jm, loss, JaxAdamW(learning_rate=LR,
                                            parameters=jm.parameters(),
                                            weight_decay=0.01))
    batch = [Tensor(a) for a in _batch()]
    return [float(jstep(*batch)) for _ in range(3)], jstep.params


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o1"])
def test_hybrid_ernie_matches_the_jax_single_device_step(world, amp):
    """sharding = 2 x mp = 2 through ``apply_hybrid_specs``, ZeRO over
    sharding, 3 steps from the JAX weights at dropout 0: in f32 losses
    and every gathered parameter within 1e-5 of the JAX single-device
    step (the key bias within ``_atol``); under O1 losses within
    ``rtol=1e-2`` (the dryrun leg C's). The weighted MLM mean counts its
    weights over both sharding ranks (row 6 holds a zero weight)."""
    jl, jparams = _jax_steps(amp)
    res = [r["o1" if amp else "f32"] for r in world[1]]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_allclose(r["losses"], jl,
                                   rtol=1e-2 if amp else 1e-5, atol=0)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    if amp:
        return
    params = res[0]["params"]
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k], np.asarray(v),
                                   atol=_atol(k), rtol=0, err_msg=k)


def _atol(name: str) -> float:
    """1e-5, but for the key projection's bias: its gradient is 0 in
    exact arithmetic (a constant added to every score of a row), so each
    side holds reassociation noise and Adam's update divides it by its
    own magnitude: up to lr a step either way, ``2 * lr * steps`` apart
    (as phase 21's key-bias tolerance)."""
    return 2 * LR * 3 if name.endswith("k_proj.bias") else 1e-5


def test_stamped_blocks_have_the_jax_shapes(world):
    """Each rank holds the JAX mesh's block of every stamped parameter:
    q/k/v and linear1 split by columns, out_proj and linear2 by rows, the
    word table by vocab rows, everything else whole; the word table's
    Adam moment is also split over sharding (as
    ``test_hybrid_tp_zero_on_mesh``); a model without stamped specs
    stays replicated."""
    E, FF, V = CFG["hidden_size"], CFG["intermediate_size"], \
        CFG["vocab_size"]
    for r in world[1]:
        sh = r["shapes"]
        pre = "ernie.encoder.layers.0."
        assert sh[pre + "self_attn.q_proj.weight"] == (E, E // 2)
        assert sh[pre + "self_attn.k_proj.bias"] == (E // 2,)
        assert sh[pre + "self_attn.out_proj.weight"] == (E // 2, E)
        assert sh[pre + "self_attn.out_proj.bias"] == (E,)
        assert sh[pre + "linear1.weight"] == (E, FF // 2)
        assert sh[pre + "linear2.weight"] == (FF // 2, E)
        assert sh["ernie.embeddings.word_embeddings.weight"] == (V // 2, E)
        assert sh["ernie.embeddings.position_embeddings.weight"] == \
            (CFG["max_position_embeddings"], E)
        assert sh["decoder_bias"] == (V,)
        assert r["slot_shape"] == (V // 2, E // 2)
        assert r["replicated"] == (E, E)


def test_decoder_bias_gradient_is_whole_and_equal_on_every_mp_rank(world):
    """The replicated ``decoder_bias`` under a vocab-block head: every mp
    rank's gradient is the whole vector (both vocab halves nonzero) and
    equal bit for bit across the mp group."""
    res = world[1]
    for r in res:
        grads = r["bias_grad"]
        a, b = (grads[i] for i in r["bias_grad_mp_group"])
        np.testing.assert_array_equal(a, b)
        V = CFG["vocab_size"]
        assert np.abs(a[:V // 2]).sum() > 0 and np.abs(a[V // 2:]).sum() > 0


def test_hybrid_dropout_equals_the_single_process_step(world):
    """At dropout 0.1 (hidden and attention) a model built with ``mesh=``
    (each rank materializes and cuts one layer at a time) draws each
    rank's rows' and heads' slice of the single-process masks (rows 2, 4
    and 5's batch and head bases): losses and parameters within 1e-5 of
    the port's single-process step from the same seed."""
    m = ErnieForPretraining(ernie_tiny(**CFG, hidden_dropout_prob=0.1,
                                       attention_dropout_prob=0.1),
                            device="cpu", seed=3)

    def loss(layer, ids, tt, mask, pos, labels, w, sop):
        return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
    step = TrainStep(m, loss, AdamW(LR, parameters=m.parameters(),
                                    weight_decay=0.01), seed=0)
    batch = [torch.from_numpy(a) for a in _batch()]
    sl = [float(step(*batch)) for _ in range(3)]
    res = world[1]
    for r in res:
        np.testing.assert_allclose(r["dropout"]["losses"], sl, rtol=1e-5,
                                   atol=0)
    for k, v in step.state_dict()["params"].items():
        np.testing.assert_allclose(res[0]["dropout"]["params"][k], v,
                                   atol=_atol(k), rtol=0, err_msg=k)


def test_encoder_step_is_refused_on_an_sp_mesh(world):
    """The encoder does not run sequence-parallel: a step over ERNIE at
    sp = 2 x mp = 2 raises on every rank rather than train each sp rank
    on its shard of the sequence."""
    for r in world[1]:
        msg = r["sp_refused"]
        assert msg is not None and "sequence-parallel" in msg, msg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_batch_and_head_bases_are_slices_of_the_whole(dtype):
    """Rows 2, 4 and 5 (plain versions, with a key bias and dropout): a
    launch over batch rows 1-2 and heads 2-3 with bases (1, 2) gives the
    whole launch's slices of o, lse, dq, dk and dv bit for bit (db sums
    the heads, so it is the slice's own)."""
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rng.randn(3, 24, 4, 16)
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    bias = torch.zeros(3, 24)
    bias[1, 17:] = -1e30
    rate, words, mx = 0.2, (77, 99), torch.bfloat16
    o, lse = flash_attention_plain(q, k, v, False, None, True, rate, words,
                                   bias, mxu_dtype=mx)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, do, False, None, rate,
                                      words, bias, mxu_dtype=mx)
    sl = (slice(1, 3), slice(None), slice(2, 4))
    qs, ks, vs, dos = (t[sl] for t in (q, k, v, do))
    bases = dict(batch_base=1, head_base=2, mxu_dtype=mx)
    o2, lse2 = flash_attention_plain(qs, ks, vs, False, None, True, rate,
                                     words, bias[1:3], **bases)
    g2 = flash_attention_bwd_plain(qs, ks, vs, o2, lse2, dos, False, None,
                                   rate, words, bias[1:3], **bases)
    assert torch.equal(o2, o[sl]) and torch.equal(lse2, lse[1:3, 2:4])
    for a, w in zip(g2[:3], grads[:3]):
        assert torch.equal(a, w[sl])
