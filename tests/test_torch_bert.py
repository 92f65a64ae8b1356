"""The port's BERT/ERNIE slice (``paddle_tpu_torch``) against the JAX
package on the CPU, and its biased flash kernels against their plain
versions on the card.

Kernel level: the additive key bias (the ``[B, 1, 1, Sk]`` padding mask)
sends the JAX package to its ``v1`` Pallas kernels (``_fwd_v1``, the
``_bwd_v1`` dq and dk/dv/dbias kernels), run here by the Pallas
interpreter with 128-row tiles; the port's wrappers compute their plain
versions on CPU tensors. Dropout masks agree bit for bit because both
packages hash the same seed words, taken here from the JAX key.

Model level: ``bert_tiny`` and ``ernie_tiny`` from the same weights
(copied by name) on the same padded batch, forward and ``TrainStep``, in
float32 and under AMP O1, at dropout 0: on the CPU the JAX model runs
its XLA attention, whose dropout is ``jax.random.bernoulli``, not the
hash. The ``cuda``-marked cases launch the kernels and skip without a
card; they also run where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_bert.py

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bert.py``.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertForMaskedLM, ErnieForPretraining,
                                     bert_tiny, ernie_tiny, load_jax_weights)
from paddle_tpu_torch.nn.chunked_ce import masked_lm_loss
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bias_bwd_dkv, flash_attention_bias_bwd_dq,
    flash_attention_bias_fwd, flash_attention_bwd_plain,
    flash_attention_plain)
from paddle_tpu_torch.optimizer import AdamW

NEG = np.float32(-1e30)
# -1e30 rounded to bf16 and widened back, as an O1 mask reaches the kernel
NEG_BF16 = float(torch.tensor(-1e30).to(torch.bfloat16).float())


def _jax_words(seed):
    import jax
    w = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).ravel()
    return jax.random.PRNGKey(seed), (int(w[0]), int(w[1]))


def _key_bias(lengths, S, neg=NEG):
    """``[B, S]`` float32 bias: 0 below each row's length, ``neg`` from
    it on (a length of 0 masks every key of that row)."""
    bias = np.zeros((len(lengths), S), np.float32)
    for b, n in enumerate(lengths):
        bias[b, n:] = neg
    return bias


def _attn_inputs(seed, B=3, S=256, H=2, D=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) * 0.5
            for _ in range(4)]


# -- the biased flash kernels against the JAX v1 kernels ------------------------
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("neg", [NEG, NEG_BF16], ids=["f32", "bf16"])
def test_bias_forward_matches_jax_kernel(rate, neg):
    """o and lse with padded keys and a fully masked batch row (o = 0 and
    lse = -1e30 there in both packages, the bf16-rounded -1e30 included:
    it lies below the kernels' running-max start)."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.flash_attention import _fwd
    q, k, v, _ = _attn_inputs(1)
    bias = _key_bias([256, 131, 0], 256, neg)
    _, words = _jax_words(3)
    seed = jnp.asarray(np.array(words, np.uint32).view(np.int32))
    o_ref, lse_ref = _fwd(*map(jnp.asarray, (q, k, v)),
                          jnp.asarray(bias)[:, None, None, :],
                          1.0 / math.sqrt(64), False, 128, 128, seed=seed,
                          rate=rate)
    o, lse = flash_attention_bias_fwd(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(bias),
        return_lse=True, dropout_rate=rate, seed_words=words)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=2e-5, rtol=0)
    assert np.all(o.numpy()[2] == 0.0) and np.all(lse.numpy()[2] == NEG)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("neg", [NEG, NEG_BF16], ids=["f32", "bf16"])
def test_bias_forward_at_ragged_tile_edges_matches_jax_kernel(rate, neg):
    """S = 65 and D = 128, where the f32 tensor-core kernel's tiles end
    ragged (a second key tile of one row, 32 16-byte copies a row), with a
    padded row and a fully masked one: o and lse of the plain version,
    which the kernel is held to on the card, against the JAX v1 kernel
    run by the Pallas interpreter with one 65-row block. The tolerance is
    test_bias_forward_matches_jax_kernel's scaled by D: this JAX build's
    CPU dots may run f32 as bf16 passes (conftest.py), whose error grows
    with the 128-term sums."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.flash_attention import _fwd
    S, D = 65, 128
    q, k, v, _ = _attn_inputs(4, S=S, D=D)
    bias = _key_bias([S, 40, 0], S, neg)
    _, words = _jax_words(5)
    seed = jnp.asarray(np.array(words, np.uint32).view(np.int32))
    o_ref, lse_ref = _fwd(*map(jnp.asarray, (q, k, v)),
                          jnp.asarray(bias)[:, None, None, :],
                          1.0 / math.sqrt(D), False, S, S, seed=seed,
                          rate=rate)
    o, lse = flash_attention_bias_fwd(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(bias),
        return_lse=True, dropout_rate=rate, seed_words=words)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=4e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=1e-4, rtol=0)
    assert np.all(o.numpy()[2] == 0.0) and np.all(lse.numpy()[2] == NEG)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_gradients_match_jax_vjp(rate):
    """dq, dk, dv and dbias of the differentiable entry against
    ``jax.vjp`` of the JAX one, the mask given as ``[B, 1, 1, Sk]``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.flash_attention import flash_attention as jfa
    q, k, v, do = _attn_inputs(2)
    bias = _key_bias([256, 131, 0], 256)[:, None, None, :]
    key, words = _jax_words(5)
    ref, vjp = jax.vjp(lambda a, b, c, m: jfa(
        a, b, c, bias=m, block_q=128, block_k=128, dropout_rate=rate,
        dropout_key=key), *map(jnp.asarray, (q, k, v, bias)))
    ref_grads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    got = flash_attention(*ts[:3], causal=False, dropout_rate=rate,
                          seed_words=words, bias=ts[3])
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=2e-5, rtol=0)
    for t, r in zip(ts, ref_grads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=0)


def test_plain_bias_backward_is_the_autograd_gradient():
    """On CPU tensors the bias wrappers compute the plain backward from
    the saved o and lse; from the plain forward's f32 o and lse that is
    the forward's autograd gradient, dbias included, up to f32 summation
    order (a causal case and a fully masked row included)."""
    rng = np.random.RandomState(4)
    q, k, v, do = (torch.from_numpy(rng.randn(3, 40, 2, 64)
                                    .astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(_key_bias([40, 23, 0], 40))
    for causal in (False, True):
        args = (causal, None, 0.2, (3, 4))
        o, lse = flash_attention_bias_fwd(q, k, v, bias, causal, None, True,
                                          0.2, (3, 4))
        dq = flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args)
        dk, dv, db = flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                                  *args)
        plain = flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                          bias=bias)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        flash_attention_plain(*leaves[:3], causal, None, False, 0.2, (3, 4),
                              bias=leaves[3]).backward(do)
        for got, ref, t in zip((dq, dk, dv, db), plain, leaves):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
            torch.testing.assert_close(got, t.grad, rtol=1e-5, atol=1e-5)


def test_bias_wrappers_check_the_bias():
    q = torch.zeros(2, 8, 2, 64)
    with pytest.raises(ValueError, match="key bias"):
        flash_attention_bias_fwd(q, q, q, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="key bias"):
        flash_attention_bias_fwd(q, q, q, torch.zeros(2, 8, dtype=torch.bfloat16))


# -- the models against the JAX models ------------------------------------------
# D = 64 (the flash kernels' head dim) and a vocab above the chunked-CE
# threshold (4096), so the same configuration also runs on the card
SLICE = dict(vocab_size=4352, hidden_size=128, num_heads=2)


def _padded_batch(vocab, B=2, S=64, M=6, seed=0):
    """ids, token types, a 0/1 mask with row 1 padded, masked positions,
    labels and weights (the last slot of row 1 a weight-0 pad slot)."""
    rng = np.random.default_rng(seed)
    lengths = [S] + [S * 5 // 8] * (B - 1)
    ids = rng.integers(5, vocab, (B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    tt = np.zeros((B, S), np.int32)
    pos = np.zeros((B, M), np.int32)
    w = np.zeros((B, M), np.float32)
    for b, n in enumerate(lengths):
        ids[b, n:] = 0
        mask[b, :n] = 1
        tt[b, n // 2:n] = 1
        m = M if b == 0 else M - 1
        pos[b, :m] = rng.choice(np.arange(1, n), m, replace=False)
        w[b, :m] = 1.0
    labels = rng.integers(5, vocab, (B, M)).astype(np.int32)
    return ids, tt, mask, pos, labels, w


def _jax_model(kind, cfg_kw, cfg=None):
    """The JAX model of ``kind`` at config ``cfg`` (the tiny one by
    default) from ``paddle.seed(0)``, and the port's with its weights."""
    import paddle_tpu as paddle
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.models import ernie as jernie
    import paddle_tpu_torch.models as tm
    cfg = cfg or f"{kind}_tiny"
    jmod, port_cls = ((jbert, BertForMaskedLM) if kind == "bert"
                      else (jernie, ErnieForPretraining))
    paddle.seed(0)
    jm = getattr(jmod, port_cls.__name__)(getattr(jmod, cfg)(**cfg_kw))
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    port = port_cls(getattr(tm, cfg)(**cfg_kw), device="cpu")
    return jm, load_jax_weights(port, named)


@pytest.mark.parametrize("lengths", [(16, 9), (16, 0)],
                         ids=["padded", "fully-masked"])
def test_encoder_layer_matches_jax(lengths):
    """The post-LN exact-gelu layer as BERT and ERNIE build it, float32,
    with a padded key row, or a row whose keys are all masked (at
    dropout 0 on the CPU both packages take the plain softmax, which
    averages v uniformly there: every score rounds to -1e30)."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import TransformerEncoderLayer as JaxLayer
    from paddle_tpu_torch.nn.layers import TransformerEncoderLayer
    paddle.seed(0)
    jl = JaxLayer(64, 4, 128, dropout=0.0, activation="gelu",
                  act_dropout=0.0, normalize_before=False)
    tl = TransformerEncoderLayer(64, 4, 128, dropout=0.0)
    load_jax_weights(tl, {k: np.asarray(v._data)
                          for k, v in jl.state_dict().items()})
    x = np.random.RandomState(0).randn(2, 16, 64).astype(np.float32)
    bias = _key_bias(list(lengths), 16)[:, None, None, :]
    ref = jl(paddle.to_tensor(x), paddle.to_tensor(bias))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_bert_tiny_forward_matches_jax():
    import paddle_tpu as paddle
    jm, pm = _jax_model("bert", {})
    ids, tt, mask, pos, _, _ = _padded_batch(256)
    jargs = [paddle.to_tensor(a) for a in (ids, tt, mask)]
    targs = [torch.from_numpy(a) for a in (ids, tt, mask)]
    jseq, jpooled = jm.bert(*jargs)
    jscores = jm(*jargs, paddle.to_tensor(pos))
    with torch.no_grad():
        tseq, tpooled = pm.bert(*targs)
        tscores = pm(*targs, torch.from_numpy(pos))
    for got, ref in ((tseq, jseq), (tpooled, jpooled), (tscores, jscores)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                                   rtol=0)
    assert tscores.shape == (2, 6, 256)


@pytest.mark.parametrize("V", [256, 4352])
def test_masked_lm_loss_matches_jax(V):
    """The dense branch below the 4096 threshold and the streamed one
    above it, weighted, with weight-0 pad slots."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.chunked_ce import masked_lm_loss as jax_mlm_loss
    rng = np.random.RandomState(V)
    logits = (rng.randn(3, 5, V) * 2).astype(np.float32)
    labels = rng.randint(0, V, (3, 5)).astype(np.int32)
    w = (rng.rand(3, 5) > 0.3).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda lg: jax_mlm_loss(
        lg, jnp.asarray(labels), jnp.asarray(w)))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = masked_lm_loss(tl, torch.from_numpy(labels), torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref_g),
                               atol=1e-7, rtol=0)


def _bert_loss(amp):
    def loss(layer, ids, tt, mask, pos, labels, w):
        if amp:
            with auto_cast(level="O1"):
                return layer.loss(layer(ids, tt, mask, pos), labels, w)
        return layer.loss(layer(ids, tt, mask, pos), labels, w)
    return loss


def _jax_bert_loss(amp):
    import paddle_tpu as paddle

    def loss(layer, ids, tt, mask, pos, labels, w):
        if amp:
            with paddle.amp.auto_cast(level="O1"):
                return layer.loss(layer(ids, tt, mask, pos), labels, w)
        return layer.loss(layer(ids, tt, mask, pos), labels, w)
    return loss


def _steps(kind, cfg_kw, amp, jloss, tloss, batch, n=3, lr=1e-4, wd=0.01,
           jax_cfg=None):
    """n steps of the JAX TrainStep and the port's from the same weights;
    returns the JAX step, the port's model and both loss lists."""
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    jm, pm = _jax_model(kind, cfg_kw, jax_cfg)
    jstep = JaxTrainStep(jm, jloss(amp), JaxAdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=wd))
    pstep = TrainStep(pm, tloss(amp), AdamW(lr, parameters=pm.parameters(),
                                            weight_decay=wd))
    jl = [float(jstep(*batch)) for _ in range(n)]
    tl = [float(pstep(*batch)) for _ in range(n)]
    return jstep, pm, jl, tl


def _assert_params(jstep, pm, atol):
    sd = pm.state_dict()
    assert set(jstep.params) == set(sd)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(v), atol=atol,
                                   rtol=0, err_msg=k)


def test_bert_trainstep_f32_matches_jax_trainstep():
    batch = _padded_batch(SLICE["vocab_size"])
    jstep, pm, jl, tl = _steps("bert", SLICE, False, _jax_bert_loss,
                               _bert_loss, batch)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[2] < tl[0]
    _assert_params(jstep, pm, 1e-5)


def test_bert_trainstep_o1_matches_jax_trainstep_and_its_dtypes():
    """Under O1 the embeddings, every layer's output, the sequence and
    the scores are bf16 in both packages (BERT's FFN bias is cast with
    its linear, so nothing promotes to f32); losses agree to bf16
    rounding (atol 2e-2 on losses near 8.4)."""
    import paddle_tpu as paddle
    batch = _padded_batch(SLICE["vocab_size"])
    ids, tt, mask, pos = batch[:4]
    jm, pm = _jax_model("bert", SLICE)
    bias = ((1.0 - mask.astype(np.float32)) * NEG)[:, None, None, :]
    with paddle.amp.auto_cast(level="O1"):
        jx = jm.bert.embeddings(paddle.to_tensor(ids), paddle.to_tensor(tt))
        j0 = jm.bert.encoder.layers[0](jx, paddle.to_tensor(bias))
        j1 = jm.bert.encoder.layers[1](j0, paddle.to_tensor(bias))
        jargs = [paddle.to_tensor(a) for a in (ids, tt, mask)]
        jdt = [str(t.dtype) for t in (jx, j0, j1, jm.bert(*jargs)[0],
                                      jm(*jargs, paddle.to_tensor(pos)))]
    with auto_cast(level="O1"), torch.no_grad():
        targs = [torch.from_numpy(a) for a in (ids, tt, mask)]
        tx = pm.bert.embeddings(targs[0], targs[1])
        t0 = pm.bert.encoder.layers[0](tx, torch.from_numpy(bias))
        t1 = pm.bert.encoder.layers[1](t0, torch.from_numpy(bias))
        tdt = [str(t.dtype).replace("torch.", "")
               for t in (tx, t0, t1, pm.bert(*targs)[0],
                         pm(*targs, torch.from_numpy(pos)))]
    assert tdt == jdt == ["bfloat16"] * 5
    _, _, jl, tl = _steps("bert", SLICE, True, _jax_bert_loss, _bert_loss,
                          batch)
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert tl[2] < tl[0]


def _ernie_loss(amp):
    def loss(layer, ids, tt, mask, pos, labels, w, sop):
        if amp:
            with auto_cast(level="O1"):
                return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
        return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
    return loss


def _jax_ernie_loss(amp):
    import paddle_tpu as paddle

    def loss(layer, ids, tt, mask, pos, labels, w, sop):
        if amp:
            with paddle.amp.auto_cast(level="O1"):
                return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
        return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
    return loss


def test_ernie_tiny_forward_loss_and_steps_match_jax():
    """MLM and SOP scores, the summed loss and three f32 steps; as in
    ``bench_ernie`` no task-type ids are passed, so the task-type table
    is updated by weight decay alone."""
    import paddle_tpu as paddle
    jm, pm = _jax_model("ernie", {})
    batch = _padded_batch(512)
    sop = np.array([0, 1], np.int32)
    jargs = [paddle.to_tensor(a) for a in batch[:4]]
    targs = [torch.from_numpy(a) for a in batch[:4]]
    jmlm, jsop = jm(*jargs)
    with torch.no_grad():
        tmlm, tsop = pm(*targs)
        tloss = pm.loss(tmlm, tsop, torch.from_numpy(batch[4]),
                        torch.from_numpy(sop), torch.from_numpy(batch[5]))
    jloss = jm.loss(jmlm, jsop, paddle.to_tensor(batch[4]),
                    paddle.to_tensor(sop), paddle.to_tensor(batch[5]))
    np.testing.assert_allclose(tmlm.numpy(), jmlm.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tsop.numpy(), jsop.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-4, rtol=0)
    jstep, pm, jl, tl = _steps("ernie", {}, False, _jax_ernie_loss,
                               _ernie_loss, batch + (sop,))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    _assert_params(jstep, pm, 1e-5)


def test_ernie_base_full_width_steps_match_jax_jump_included():
    """ERNIE-base at full width (2 layers), float32, dropout 0, AdamW at
    ``bench_ernie``'s lr 1e-4: the loss jumps at step 2 in both packages
    alike. Adam's first update is about lr * sign(g) on every weight, and
    those moves add up coherently over the 768-wide sums that feed the
    pooler and the SOP logits, which swing by several units."""
    kw = dict(num_layers=2, hidden_dropout_prob=0.0,
              attention_dropout_prob=0.0)
    batch = _padded_batch(18000, B=4, S=128, M=20) + \
        (np.array([0, 1, 1, 0], np.int32),)
    jstep, pm, jl, tl = _steps("ernie", kw, False, _jax_ernie_loss,
                               _ernie_loss, batch, jax_cfg="ernie_base")
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert jl[1] > jl[0] + 1.0


def test_ernie_trainstep_o1_matches_jax_trainstep():
    """Three O1 steps at the slice's widths (the MLM loss streamed, the
    SOP loss dense in float32): losses agree to bf16 rounding."""
    batch = _padded_batch(SLICE["vocab_size"]) + (np.array([1, 0], np.int32),)
    _, _, jl, tl = _steps("ernie", SLICE, True, _jax_ernie_loss, _ernie_loss,
                          batch)
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert all(math.isfinite(x) for x in tl) and tl[2] < tl[0]


def test_unused_parameters_update_as_in_jax():
    """With no token-type ids the loss reaches neither the token-type
    table nor the pooler (BertForMaskedLM drops ``pooled``). The JAX
    TrainStep differentiates every trainable parameter, so they get zero
    gradients and AdamW still decays them (and moves them by their
    momentum); the port's TrainStep gives them zero gradients too. A
    large lr and decay put lr * wd * p far above float32 noise, and
    epsilon 1e-3 keeps Adam's step continuous in gradients near 0, where
    the two packages' float32 sums differ in their last bits."""
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    jm, pm = _jax_model("bert", SLICE)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    ids, _, mask, pos, labels, w = _padded_batch(SLICE["vocab_size"])

    def jloss(layer, ids, mask, pos, labels, w):
        return layer.loss(layer(ids, None, mask, pos), labels, w)

    def tloss(layer, ids, mask, pos, labels, w):
        return layer.loss(layer(ids, None, mask, pos), labels, w)

    jstep = JaxTrainStep(jm, jloss, JaxAdamW(
        learning_rate=1e-2, epsilon=1e-3, parameters=jm.parameters(),
        weight_decay=0.1))
    pstep = TrainStep(pm, tloss, AdamW(1e-2, epsilon=1e-3,
                                       parameters=pm.parameters(),
                                       weight_decay=0.1))
    for _ in range(2):
        jstep(ids, mask, pos, labels, w)
        pstep(ids, mask, pos, labels, w)
    after = pm.state_dict()
    for k, b in before.items():
        ref = np.asarray(jstep.params[k]) - b.numpy()
        got = (after[k] - b).numpy()
        # the key bias's gradient is 0 in exact arithmetic (the softmax
        # ignores a constant per query row): its updates are float32
        # noise of both packages, below the 1e-8 floor
        np.testing.assert_allclose(got, ref, rtol=0, err_msg=k,
                                   atol=max(1e-3 * np.abs(ref).max(), 1e-8))
    for k in ("bert.pooler.weight", "bert.embeddings.token_type_embeddings"
              ".weight"):
        assert np.abs((after[k] - before[k]).numpy()).max() > 0, k


# -- the kernels on the card ------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("S", [128, 200, 512])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_kernels_match_plain_on_card(cuda, dtype, tol, S, rate):
    """Padded keys and a fully masked batch row; the plain backward is
    fed the kernel's o and lse. In bf16 an element may differ by one
    ulp, at most 2^-7 of the largest; db is f32 in both."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn(3, S, 4, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    bias = torch.from_numpy(_key_bias([S, S // 3, 0], S)).to(cuda)
    words = (21, 22)
    counts = [kk.launches for kk in (kernels.FLASH_ATTENTION_BIAS_FWD,
                                     kernels.FLASH_ATTENTION_BIAS_BWD_DQ,
                                     kernels.FLASH_ATTENTION_BIAS_BWD_DKV)]
    o, lse = flash_attention_bias_fwd(q, k, v, bias, return_lse=True,
                                      dropout_rate=rate, seed_words=words)
    o_ref, lse_ref = flash_attention_plain(q, k, v, False, None, True, rate,
                                           words, bias)
    assert _rel_err(o, o_ref) <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert (o[2] == 0).all() and (lse[2] == -1e30).all()
    args = (False, None, rate, words)
    dq = flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args)
    dk, dv, db = flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                              *args)
    assert [kk.launches for kk in (kernels.FLASH_ATTENTION_BIAS_FWD,
                                   kernels.FLASH_ATTENTION_BIAS_BWD_DQ,
                                   kernels.FLASH_ATTENTION_BIAS_BWD_DKV)] \
        == [c + 1 for c in counts]
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, *args, bias=bias)
    for got, ref in zip((dq, dk, dv, db), refs):
        assert got.dtype == ref.dtype
        assert _rel_err(got, ref) <= (tol if got.dtype == dtype else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,causal", [(200, 200, 128, False),
                                            (100, 260, 64, True),
                                            (64, 64, 64, False)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_bias_backward_on_tensor_cores_matches_plain(cuda, Sq, Sk, D,
                                                          causal, rate):
    """The bf16 dq and dk/dv/dbias kernels on the tensor cores: padded
    keys and a fully masked batch row, D = 128, causal Sk != Sq. dq, dk,
    dv within 2^-7 of the largest of the plain version with bf16 MXU
    operands and of the float32 one; db, summed from the f32 score
    gradient, within 1e-4 of both; a second call repeats the first bit
    for bit (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q, do = (torch.randn(3, Sq, 4, D, device=cuda, generator=g)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(3, Sk, 4, D, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(2))
    bias = torch.from_numpy(_key_bias([Sk, Sk // 3, 0], Sk)).to(cuda)
    args = (causal, None, rate, (41, 42))
    o, lse = flash_attention_bias_fwd(q, k, v, bias, causal, None, True,
                                      rate, (41, 42))
    assert (o[2] == 0).all() and (lse[2] == -1e30).all()

    def grads():
        return (flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args),
                *flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                              *args))
    got = grads()
    for a, b in zip(got, grads()):
        assert torch.equal(a, b)
    for mxu in (torch.bfloat16, None):
        refs = flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                         bias=bias, mxu_dtype=mxu)
        for t, ref in zip(got, refs):
            assert t.dtype == ref.dtype
            assert _rel_err(t, ref) <= (2.0 ** -7 if t.dtype == torch.bfloat16
                                        else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,causal", [(200, 200, 64, False),
                                            (333, 333, 128, False),
                                            (130, 333, 64, True),
                                            (72, 200, 128, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("neg", [NEG, NEG_BF16], ids=["f32", "bf16"])
def test_bf16_bias_forward_on_tensor_cores_matches_plain(cuda, Sq, Sk, D,
                                                         causal, rate, neg):
    """The bf16 biased forward on the tensor cores: padded keys and a
    fully masked batch row (o == 0 and lse == -1e30 exactly, with the
    f32 and the bf16-rounded -1e30), D = 128, causal Sk != Sq, with and
    without dropout. o within 2^-7 of the largest of the plain version
    with bf16 MXU operands and of the float32 one, lse within 1e-4 of
    both; a second call repeats the first bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + 2)
    q = torch.randn(3, Sq, 4, D, device=cuda, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(3, Sk, 4, D, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(2))
    bias = torch.from_numpy(_key_bias([Sk, Sk // 3, 0], Sk, neg)).to(cuda)
    args = (causal, None, True, rate, (43, 44))
    before = kernels.FLASH_ATTENTION_BIAS_FWD.launches
    o, lse = flash_attention_bias_fwd(q, k, v, bias, *args)
    assert kernels.FLASH_ATTENTION_BIAS_FWD.launches == before + 1
    assert (o[2] == 0).all() and (lse[2] == -1e30).all()
    again = flash_attention_bias_fwd(q, k, v, bias, *args)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    for mxu in (torch.bfloat16, None):
        o_ref, lse_ref = flash_attention_plain(q, k, v, *args, bias,
                                               mxu_dtype=mxu)
        assert _rel_err(o, o_ref) <= 2.0 ** -7
        assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,causal", [(65, 65, 128, False),
                                            (65, 65, 64, False),
                                            (200, 200, 64, False),
                                            (512, 512, 64, False),
                                            (333, 333, 128, False),
                                            (130, 333, 64, True),
                                            (72, 200, 128, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("neg", [NEG, NEG_BF16], ids=["f32", "bf16"])
def test_f32_bias_forward_on_tensor_cores_matches_plain(cuda, Sq, Sk, D,
                                                        causal, rate, neg):
    """The f32 biased forward on the tensor cores (3xTF32): padded keys
    and a fully masked batch row (o == 0 and lse == -1e30 exactly, with
    the f32 and the bf16-rounded -1e30: the split never sees the bias),
    ragged S, D = 128, causal Sk != Sq, with and without dropout. o within
    1e-4 of the float32 plain version (chip_smoke.py's TOL["float32"]),
    lse within 1e-5; a second call repeats the first bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + 3)
    q = torch.randn(3, Sq, 4, D, device=cuda, generator=g)
    k, v = (torch.randn(3, Sk, 4, D, device=cuda, generator=g)
            for _ in range(2))
    bias = torch.from_numpy(_key_bias([Sk, Sk // 3, 0], Sk, neg)).to(cuda)
    args = (causal, None, True, rate, (45, 46))
    before = kernels.FLASH_ATTENTION_BIAS_FWD.launches
    o, lse = flash_attention_bias_fwd(q, k, v, bias, *args)
    again = flash_attention_bias_fwd(q, k, v, bias, *args)
    assert kernels.FLASH_ATTENTION_BIAS_FWD.launches == before + 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert (o[2] == 0).all() and (lse[2] == -1e30).all()
    o_ref, lse_ref = flash_attention_plain(q, k, v, *args, bias)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,causal", [(65, 65, 64, False),
                                            (65, 65, 128, False),
                                            (200, 200, 64, False),
                                            (200, 200, 128, False),
                                            (512, 512, 64, False),
                                            (130, 333, 64, True),
                                            (72, 200, 128, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("neg", [NEG, NEG_BF16], ids=["f32", "bf16"])
def test_f32_backward_on_tensor_cores_matches_plain_on_card(cuda, Sq, Sk, D,
                                                            causal, rate,
                                                            neg):
    """The f32 dq and dk/dv/dbias kernels on the tensor cores (3xTF32):
    padded keys and a fully masked batch row, with the f32 and the
    bf16-rounded -1e30, ragged S, D = 128, causal Sk != Sq, with and
    without dropout, with batch and head bases. dq, dk, dv and db within
    1e-4 of the largest of the float32 plain version (chip_smoke.py's
    TOL["float32"]); a second call repeats the first bit for bit (no
    atomics)."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + 4)
    q, do = (torch.randn(3, Sq, 4, D, device=cuda, generator=g)
             for _ in range(2))
    k, v = (torch.randn(3, Sk, 4, D, device=cuda, generator=g)
            for _ in range(2))
    bias = torch.from_numpy(_key_bias([Sk, Sk // 3, 0], Sk, neg)).to(cuda)
    args = (causal, None, rate, (47, 48))
    bases = dict(batch_base=5, head_base=3)
    o, lse = flash_attention_bias_fwd(q, k, v, bias, causal, None, True,
                                      rate, (47, 48), **bases)
    assert (o[2] == 0).all() and (lse[2] == -1e30).all()

    def grads():
        return (flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args,
                                            **bases),
                *flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                              *args, **bases))
    counts = [kk.launches for kk in (kernels.FLASH_ATTENTION_BIAS_BWD_DQ,
                                     kernels.FLASH_ATTENTION_BIAS_BWD_DKV)]
    got = grads()
    for a, b in zip(got, grads()):
        assert torch.equal(a, b)
    assert [kk.launches for kk in (kernels.FLASH_ATTENTION_BIAS_BWD_DQ,
                                   kernels.FLASH_ATTENTION_BIAS_BWD_DKV)] \
        == [c + 2 for c in counts]
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, *args, bias=bias,
                                     **bases)
    for t, ref in zip(got, refs):
        assert t.dtype == torch.float32
        assert _rel_err(t, ref) <= 1e-4


@pytest.mark.cuda
def test_tiny_bert_trainstep_on_card_launches_the_bias_kernels(cuda):
    cfg = bert_tiny(**SLICE, hidden_dropout_prob=0.1,
                    attention_dropout_prob=0.1)
    m = BertForMaskedLM(cfg, device=cuda)
    step = TrainStep(m, _bert_loss(True), AdamW(1e-3,
                                                parameters=m.parameters()))
    batch = _padded_batch(cfg.vocab_size)
    kernels.reset_launch_counts()
    losses = [float(step(*batch)) for _ in range(2)]
    assert all(math.isfinite(x) for x in losses)
    n = {kk["name"]: kk["launches"] for kk in kernels.kernels()}
    L, drops = cfg.num_layers, 1 + 2 * cfg.num_layers
    assert n == {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "chunked_ce_lse": 2, "chunked_ce_dlogits": 2,
                 "fused_dropout": 2 * 2 * drops,
                 "paged_decode_attention": 0,
                 "flash_attention_bias_fwd": 2 * L,
                 "flash_attention_bias_bwd_dq": 2 * L,
                 "flash_attention_bias_bwd_dkv": 2 * L,
                 "paged_decode_attention_quant": 0, "bgmv": 0,
                 "int8_matmul": 0}
