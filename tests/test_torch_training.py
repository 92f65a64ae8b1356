"""The port's training slice (``paddle_tpu_torch``) against the JAX
package on the CPU, and its training kernels against their plain
versions on the card.

Kernel level: the same numpy-seeded inputs go through the JAX Pallas
kernels (run by the Pallas interpreter, as the JAX package's own tests
run them) and through the port's wrappers, which compute their plain
versions on CPU tensors. Dropout masks agree bit for bit because both
packages hash the same seed words, taken here from the JAX key.

Slice level: the JAX ``TrainStep`` and the port's train ``gpt_tiny``
from the same weights (copied by name) on the same batch, in float32 and
under AMP O1. The ``cuda``-marked cases launch the kernels and skip
without a card; they also run where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_training.py
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.core import seed_words
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import chunked_ce as tce
from paddle_tpu_torch.ops.kernels.dropout import dropout_plain, fused_dropout
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bias_fwd, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain)
from paddle_tpu_torch.optimizer import Adam, AdamW, ClipGradByGlobalNorm

# a vocab above the chunked-CE threshold (4096) and not a multiple of
# 8192, and D = 64 (the flash kernels' head dim)
SLICE = dict(vocab_size=4352, hidden_size=128, num_heads=2)


def _jax_words(seed):
    import jax
    w = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).ravel()
    return jax.random.PRNGKey(seed), (int(w[0]), int(w[1]))


def _bits(a):
    """The raw bits of a torch tensor or a JAX/numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16 if a.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# -- fused dropout ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 256), (4, 8, 384), (3, 5, 7), (1000,)])
def test_fused_dropout_bit_equal_to_jax_kernel(dtype, shape):
    """Aligned shapes take the JAX kernel's [*, C] view, the others its
    padded [*, 128] one; both index the flat array, and so does the
    port. The backward reruns the kernel on the gradient."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.dropout import fused_dropout as jax_dropout
    key, words = _jax_words(sum(shape))
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref, vjp = jax.vjp(lambda a: jax_dropout(a, 0.1, key), jx)
    (ref_g,) = vjp(jnp.asarray(g).astype(dtype))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    got = fused_dropout(tx, 0.1, words)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(tx.grad), _bits(ref_g))


def test_dropout_multiplier_is_rounded_to_the_dtype_first():
    x = torch.ones(64, dtype=torch.bfloat16)
    kept = dropout_plain(x, 0.1, (1, 2))
    assert set(kept.float().unique().tolist()) == {0.0, 1.109375}
    kept32 = dropout_plain(x.float(), 0.1, (1, 2))
    assert set(kept32.unique().tolist()) == {0.0, float(np.float32(1 / 0.9))}


# -- flash attention with dropout ------------------------------------------------
def test_flash_dropout_forward_and_grads_match_jax_kernel():
    """S=512 with 128-row tiles in the JAX kernel, so the tile offsets of
    the hash matter; the port hashes absolute rows and columns."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.flash_attention import flash_attention as jfa
    key, words = _jax_words(7)
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(1, 512, 2, 64).astype(np.float32) * 0.5
                   for _ in range(4))
    ref, vjp = jax.vjp(lambda a, b, c: jfa(
        a, b, c, causal=True, block_q=128, block_k=128, dropout_rate=0.1,
        dropout_key=key), *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, dropout_rate=0.1,
                          seed_words=words)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=2e-5, rtol=0)
    for t, r in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("causal,padded", [(True, False), (False, True)])
def test_plain_backward_with_bf16_mxu_operands_matches_jax_kernel(
        monkeypatch, causal, padded):
    """``mxu_dtype=torch.bfloat16`` rounds the operands of the five
    products to bf16 and sums in f32, as the TPU kernels' ``_dot`` does
    when ``_mxu_dtype`` gives bf16 (the default precision policy on a TPU;
    the interpreter keeps f32, so it is patched here). The plain version
    is fed the JAX forward's o and its own lse: they differ from the
    kernel's in the last f32 bit, which flips the bf16 rounding of a few
    p.V and ds entries, so the gradients agree within 2e-4 of the
    largest (7.2e-5 measured), and on average to a hundredth of the
    float32 plain version's distance from the kernel (5.6e-4 measured)."""
    import importlib

    import jax
    import jax.numpy as jnp
    jmod = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    monkeypatch.setattr(jmod, "_mxu_dtype", lambda dtype: jnp.bfloat16)
    key, words = _jax_words(7)
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 256, 2, 64)
                                    .astype(np.float32))
                   .to(torch.bfloat16).float() for _ in range(4))
    bias = None
    if padded:
        bias = torch.zeros(1, 256)
        bias[0, 200:] = -1e30
    o, vjp = jax.vjp(lambda a, b, c: jmod.flash_attention(
        a, b, c, bias=None if bias is None else jnp.asarray(
            bias.numpy())[:, None, None, :],
        causal=causal, block_q=128, block_k=128, dropout_rate=0.1,
        dropout_key=key), *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    lse = flash_attention_plain(q, k, v, causal, None, True, 0.1, words,
                                bias)[1]
    args = (q, k, v, torch.from_numpy(np.array(o)), lse, do, causal, None,
            0.1, words, bias)
    mxu = flash_attention_bwd_plain(*args, mxu_dtype=torch.bfloat16)[:3]
    f32 = flash_attention_bwd_plain(*args)[:3]
    for a, b, r in zip(mxu, f32, ref):
        assert np.abs(a.numpy() - r).max() <= 2e-4 * np.abs(r).max()
        assert np.abs(a.numpy() - r).mean() <= \
            1e-2 * np.abs(b.numpy() - r).mean()


@pytest.mark.parametrize("causal,padded", [(True, False), (False, True)])
def test_plain_forward_with_bf16_mxu_operands_matches_jax_kernel(
        monkeypatch, causal, padded):
    """``flash_attention_plain(..., mxu_dtype=torch.bfloat16)`` rounds q,
    k, v and ``pv = p * keep`` to bf16 and sums in f32, as the TPU
    kernels' ``_dot`` does when ``_mxu_dtype`` gives bf16 (patched here,
    as above); l and lse keep the unrounded p. At S=256 the JAX kernel's
    default block takes a row's keys in one tile, so both versions round
    p relative to the same row max, and only the last f32 bits of s and p
    differ, which may flip the bf16 rounding of a pv entry: o agrees
    within 1e-5 of the largest (9.5e-8 causal, 3.2e-7 padded measured),
    and on average to a thousandth of the float32 plain version's
    distance from the kernel (6.7e-5 and 7.8e-5 of it measured; that
    distance is 1.5e-3 of the largest)."""
    import importlib

    import jax
    import jax.numpy as jnp
    jmod = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    monkeypatch.setattr(jmod, "_mxu_dtype", lambda dtype: jnp.bfloat16)
    key, words = _jax_words(8)
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, 256, 2, 64).astype(np.float32))
               .to(torch.bfloat16).float() for _ in range(3))
    bias = None
    if padded:
        bias = torch.zeros(2, 256)
        bias[0, 200:] = -1e30
        bias[1, 77:] = -1e30
    ref = np.asarray(jmod.flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)),
        bias=None if bias is None else jnp.asarray(
            bias.numpy())[:, None, None, :],
        causal=causal, dropout_rate=0.1, dropout_key=key))
    args = (q, k, v, causal, None, True, 0.1, words, bias)
    mxu, lse_mxu = flash_attention_plain(*args, mxu_dtype=torch.bfloat16)
    f32, lse_f32 = flash_attention_plain(*args)
    assert torch.equal(lse_mxu, lse_f32)
    err, err_f32 = np.abs(mxu.numpy() - ref), np.abs(f32.numpy() - ref)
    assert err.max() <= 1e-5 * np.abs(ref).max()
    assert err.mean() <= 1e-3 * err_f32.mean()


def test_flash_backward_wrapper_is_the_plain_gradient():
    """On CPU tensors the wrapper computes the plain backward, which reads
    the saved o and lse as ``_bwd2`` does; from the plain forward's f32 o
    and lse that is the forward's autograd gradient, up to f32
    summation order."""
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 40, 2, 64)
                                    .astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, dropout_rate=0.2,
                                 seed_words=(3, 4))
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dropout_rate=0.2,
                                     seed_words=(3, 4))
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, dropout_rate=0.2,
                                      seed_words=(3, 4))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_plain(*qkv, dropout_rate=0.2,
                          seed_words=(3, 4)).backward(do)
    for got, ref, t in zip((dq, dk, dv), plain, qkv):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        torch.testing.assert_close(got, t.grad, rtol=1e-5, atol=1e-5)


# -- chunked cross-entropy ---------------------------------------------------------
@pytest.mark.parametrize("N,V,chunk", [(37, 1000, 256), (16, 4352, 4352),
                                       (4, tce.PLAIN_CHUNK + 1000, 4096)])
def test_chunked_ce_loss_and_grad_match_jax_kernel(N, V, chunk):
    """``chunk`` is the JAX kernel's vocab tile; the port's plain version
    walks ``PLAIN_CHUNK``-wide slices, two of them in the last case."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.chunked_ce import chunked_ce_loss
    rng = np.random.RandomState(N)
    logits = (rng.randn(N, V) * 3).astype(np.float32)
    labels = rng.randint(0, V, (N,)).astype(np.int32)
    w = rng.rand(N).astype(np.float32)
    jl = jnp.asarray(logits)
    ref = np.asarray(chunked_ce_loss(jl, jnp.asarray(labels), chunk))
    ref_g = np.asarray(jax.grad(lambda a: jnp.sum(chunked_ce_loss(
        a, jnp.asarray(labels), chunk) * jnp.asarray(w)))(jl))
    tl = torch.from_numpy(logits).requires_grad_()
    got = tce.chunked_ce_loss(tl, torch.from_numpy(labels))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.grad.numpy(), ref_g, atol=1e-5, rtol=0)


def test_lse_of_a_fully_masked_row_is_neg_inf_and_its_gradient_finite():
    logits = torch.full((2, 10), -1e30)
    logits[1, 3] = 0.0
    lse = tce.online_lse(logits)
    assert lse[0].item() == float(np.float32(-1e30))
    assert lse[1].item() == 0.0
    d = tce.dlogits(logits, torch.tensor([0, 3]), lse, torch.ones(2))
    assert torch.isfinite(d).all() and d[1].abs().max().item() == 0.0


# -- optimizer ---------------------------------------------------------------------
@pytest.mark.parametrize("rule,clip", [("AdamW", None), ("AdamW", 0.5),
                                       ("Adam", None)])
def test_adamw_matches_jax_apply_gradients(rule, clip):
    """AdamW's decoupled decay and Adam's coupled L2 decay (a float
    weight_decay), with and without the global-norm clip."""
    import jax.numpy as jnp
    import paddle_tpu.optimizer as jopt_mod
    from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
    rng = np.random.RandomState(0)
    shapes = {"w": (8, 16), "b": (16,), "e": (5, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** -i).astype(np.float32)
              for k, s in shapes.items()} for i in range(3)]
    jopt = getattr(jopt_mod, rule)(learning_rate=1e-3, weight_decay=0.01,
                                   grad_clip=JaxClip(clip) if clip else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init_state(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = {"Adam": Adam, "AdamW": AdamW}[rule](
        1e-3, parameters=tparams.values(), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    for t, g in enumerate(grads, start=1):
        jp, state = jopt.apply_gradients(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, state, step=t)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step(step=t)
        topt.clear_grad()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=0)
        # the first moment cancels across steps: compare it at a
        # millionth of its largest entry
        m_ref = np.asarray(state[k][0])
        np.testing.assert_allclose(topt._accumulators[id(p)][0].numpy(),
                                   m_ref, rtol=0,
                                   atol=1e-6 * np.abs(m_ref).max())


@pytest.mark.parametrize("V", [256, 4352])
@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_criterion_matches_jax(V, masked):
    """The dense ``lse - tgt`` branch below the 4096 threshold and the
    chunked one above it, with and without a loss mask."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    rng = np.random.RandomState(V)
    logits = (rng.randn(2, 8, V) * 2).astype(np.float32)
    labels = rng.randint(0, V, (2, 8)).astype(np.int32)
    mask = (rng.rand(2, 8) > 0.3).astype(np.float32) if masked else None
    jcrit = JaxCrit()

    def jloss(lg):
        m = None if mask is None else paddle.to_tensor(mask)
        return jcrit(paddle.Tensor(lg), paddle.to_tensor(labels), m)._data

    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = GPTPretrainingCriterion()(tl, torch.from_numpy(labels),
                                    None if mask is None
                                    else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref_g),
                               atol=1e-7, rtol=0)


# -- the slice: TrainStep against the JAX TrainStep --------------------------------
def _batch(vocab, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _jax_and_port(cfg_kw, amp):
    """A seeded JAX TrainStep and the port's, same weights, same loss."""
    import paddle_tpu as paddle
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**cfg_kw))
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    jcrit = JaxCrit()

    def jloss(layer, ids, labels):
        if amp:
            with paddle.amp.auto_cast(level="O1"):
                return jcrit(layer(ids), labels)
        return jcrit(layer(ids), labels)

    jstep = JaxTrainStep(jm, jloss, JaxAdamW(
        learning_rate=1e-4, parameters=jm.parameters(), weight_decay=0.01))
    pm = load_jax_weights(GPTForPretraining(gpt_tiny(**cfg_kw),
                                            device="cpu"), named)
    crit = GPTPretrainingCriterion()

    def loss(layer, ids, labels):
        if amp:
            with auto_cast(level="O1"):
                return crit(layer(ids), labels)
        return crit(layer(ids), labels)

    pstep = TrainStep(pm, loss, AdamW(1e-4, parameters=pm.parameters(),
                                      weight_decay=0.01))
    return jm, jstep, pm, pstep


def test_trainstep_f32_matches_jax_trainstep():
    jm, jstep, pm, pstep = _jax_and_port(SLICE, amp=False)
    ids, labels = _batch(SLICE["vocab_size"])
    jl = [float(jstep(ids, labels)) for _ in range(3)]
    tl = [float(pstep(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[2] < tl[0]
    sd = pm.state_dict()
    assert set(jstep.params) == set(sd)
    for k, v in jstep.params.items():
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(v), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_trainstep_o1_matches_jax_trainstep_and_its_dtypes():
    """Under O1 the stream starts in bf16, each block's MLP bias add
    promotes its output to f32, and the layer loop keeps the stream's
    dtype, as the JAX scan carry does. Losses agree to bf16 rounding
    (atol 2e-2 on losses near 8.4)."""
    import paddle_tpu as paddle
    jm, jstep, pm, pstep = _jax_and_port(SLICE, amp=True)
    ids, labels = _batch(SLICE["vocab_size"])
    jids = paddle.to_tensor(ids)
    tids = torch.from_numpy(ids)
    pos = np.arange(ids.shape[1], dtype=np.int32)
    with paddle.amp.auto_cast(level="O1"):
        jx = jm.gpt.word_embeddings(jids) + jm.gpt.position_embeddings(
            paddle.to_tensor(pos))
        j0 = jm.gpt.layers[0](jx)
        j1 = jm.gpt.layers[1](j0)
        jdt = [str(t.dtype) for t in (jx, j0, j1, jm.gpt(jids), jm(jids))]
    with auto_cast(level="O1"), torch.no_grad():
        from paddle_tpu_torch.nn import functional as F
        tx = F.embedding(tids, pm.gpt.word_embeddings.weight) + F.embedding(
            torch.from_numpy(pos), pm.gpt.position_embeddings.weight)
        t0 = pm.gpt.layers[0](tx)
        t1 = pm.gpt.layers[1](t0)
        tdt = [str(t.dtype).replace("torch.", "")
               for t in (tx, t0, t1, pm.gpt(tids), pm(tids))]
    assert tdt == jdt == ["bfloat16", "float32", "float32", "bfloat16",
                          "bfloat16"]
    jl = [float(jstep(ids, labels)) for _ in range(3)]
    tl = [float(pstep(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert tl[2] < tl[0]


def test_auto_cast_signature_enable_and_amp_guard_match_jax():
    """``auto_cast(enable=False)`` casts nothing, also inside an enabled
    block; a positional ``auto_cast(True)`` and ``amp_guard`` are O1
    bf16; the logits agree with the JAX package's under each (f32: 1e-4,
    bf16: the O1 test's 2e-2); custom lists raise in the port."""
    import paddle_tpu as paddle
    from paddle_tpu_torch.amp import amp_guard
    jm, _, pm, _ = _jax_and_port(SLICE, amp=False)
    ids = _batch(SLICE["vocab_size"])[0]
    jids, tids = paddle.to_tensor(ids), torch.from_numpy(ids)

    cases = {
        "disabled": (lambda: paddle.amp.auto_cast(enable=False),
                     lambda: auto_cast(enable=False), "float32", 1e-4),
        "disabled inside O1": (
            lambda: _nested(paddle.amp.auto_cast(level="O1"),
                            paddle.amp.auto_cast(enable=False)),
            lambda: _nested(auto_cast(level="O1"), auto_cast(False)),
            "float32", 1e-4),
        "positional True": (lambda: paddle.amp.auto_cast(True),
                            lambda: auto_cast(True), "bfloat16", 2e-2),
        "amp_guard": (lambda: paddle.amp.amp_guard(level="O1"),
                      lambda: amp_guard(level="O1"), "bfloat16", 2e-2)}
    with torch.no_grad():
        plain = pm(tids)
    for name, (jctx, tctx, dtype, tol) in cases.items():
        with jctx():
            jout = jm(jids)
        with tctx(), torch.no_grad():
            tout = pm(tids)
        assert str(jout.dtype) == dtype, name
        assert str(tout.dtype) == f"torch.{dtype}", name
        np.testing.assert_allclose(
            tout.float().numpy(), np.asarray(jout._data).astype(np.float32),
            atol=tol, rtol=0, err_msg=name)
        if dtype == "float32":
            assert torch.equal(tout, plain), name
    with pytest.raises(NotImplementedError, match="custom"):
        with auto_cast(custom_white_list={"softmax"}):
            pass


@contextlib.contextmanager
def _nested(a, b):
    with a, b:
        yield


def test_dropout_dtypes_under_o1(monkeypatch):
    """dropout1 sees the bf16 attention branch, dropout2 the f32 MLP
    branch, and the embedding dropout the bf16 embeddings."""
    from paddle_tpu_torch.nn import functional as F
    seen = []
    real = F.fused_dropout

    def spy(x, rate, words):
        seen.append(x.dtype)
        return real(x, rate, words)

    monkeypatch.setattr(F, "fused_dropout", spy)
    cfg = gpt_tiny(**SLICE, hidden_dropout_prob=0.1,
                   attention_dropout_prob=0.1)
    m = GPTForPretraining(cfg, device="cpu")
    ids, _ = _batch(cfg.vocab_size, S=16)
    with auto_cast(level="O1"), torch.no_grad():
        m(torch.from_numpy(ids), generator=torch.Generator().manual_seed(0))
    bf, f32 = torch.bfloat16, torch.float32
    assert seen == [bf] + [bf, f32] * cfg.num_layers


def test_trainstep_state_dict_round_trip_resumes_exactly():
    cfg = gpt_tiny(**SLICE, hidden_dropout_prob=0.1,
                   attention_dropout_prob=0.1)

    def fresh():
        m = GPTForPretraining(cfg, device="cpu", seed=1)
        crit = GPTPretrainingCriterion()
        return TrainStep(m, lambda layer, i, l: crit(layer(i), l),
                         AdamW(1e-3, parameters=m.parameters()), seed=3)

    ids, labels = _batch(cfg.vocab_size, S=32)
    a = fresh()
    for _ in range(2):
        a(ids, labels)
    state = a.state_dict()
    after = [float(a(ids, labels)) for _ in range(2)]
    b = fresh()
    b.set_state_dict(state)
    assert b.step_count == 2
    assert [float(b(ids, labels)) for _ in range(2)] == after


def test_dropout_in_training_mode_needs_a_generator():
    cfg = gpt_tiny(**SLICE, hidden_dropout_prob=0.1)
    m = GPTForPretraining(cfg, device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="generator"):
        m(ids)
    m.eval()
    m(ids)


def test_seed_words_are_uint32_from_a_cpu_generator():
    g = torch.Generator().manual_seed(0)
    w = seed_words(g)
    assert all(0 <= x < 2 ** 32 for x in w) and w != seed_words(g)


# -- the kernels on the card -------------------------------------------------------
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8 * 1024 * 1024 + 3, 1000])
def test_dropout_kernel_bit_equal_to_plain_on_card(cuda, dtype, n):
    x = torch.randn(n, device=cuda).to(dtype)
    before = kernels.FUSED_DROPOUT.launches
    got = fused_dropout(x, 0.1, (123, 456))
    assert kernels.FUSED_DROPOUT.launches == before + 1
    assert torch.equal(got, dropout_plain(x, 0.1, (123, 456)))
    # an offset start takes the scalar path
    assert torch.equal(fused_dropout(x[1:], 0.1, (7, 8)),
                       dropout_plain(x[1:].contiguous(), 0.1, (7, 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("N,V", [(64, 50304), (5, 1001)])
def test_chunked_ce_kernels_match_plain_on_card(cuda, dtype, tol, N, V):
    """dlogits per element, from the same lse: within ``tol`` of the plain
    value (one bf16 ulp is at most 2^-7 of it), or of a millionth of the
    row's upstream gradient where p is smaller than that."""
    g = torch.Generator(device=cuda).manual_seed(V)
    logits = (torch.randn(N, V, device=cuda, generator=g) * 3).to(dtype)
    labels = torch.randint(0, V, (N,), device=cuda, generator=g,
                           dtype=torch.int32)
    lse = tce.online_lse(logits)
    ref = tce.online_lse_plain(logits)
    assert (lse - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    gr = torch.rand(N, device=cuda, generator=g) + 0.5
    d = tce.dlogits(logits, labels, ref, gr)
    assert d.dtype == dtype
    d_ref = tce.dlogits_plain(logits, labels, ref, gr).float()
    err = (d.float() - d_ref).abs() / (d_ref.abs() + 1e-6 * gr[:, None])
    assert err.max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("S,D,rate", [(128, 64, 0.0), (200, 64, 0.1),
                                      (256, 128, 0.1)])
def test_flash_forward_and_backward_match_plain_on_card(cuda, dtype, tol, S,
                                                        D, rate):
    """Both round to the dtype from f32 sums in other orders: in bf16 an
    element may differ by one ulp, at most 2^-7 of the largest. The
    plain backward is fed the kernel's o and lse."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn(2, S, 4, D, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    words = (11, 12)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True,
                                 dropout_rate=rate, seed_words=words)
    o_ref, lse_ref = flash_attention_plain(q, k, v, return_lse=True,
                                           dropout_rate=rate,
                                           seed_words=words)
    assert _rel_err(o, o_ref) <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    before = kernels.FLASH_ATTENTION_BWD.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, dropout_rate=rate,
                                seed_words=words)
    assert kernels.FLASH_ATTENTION_BWD.launches == before + 1
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, dropout_rate=rate,
                                     seed_words=words)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype
        assert _rel_err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,rate", [(200, 200, 64, 0.0),
                                          (200, 200, 64, 0.1),
                                          (256, 256, 128, 0.1),
                                          (200, 200, 128, 0.0),
                                          (72, 200, 64, 0.1),
                                          (130, 333, 128, 0.1)])
def test_bf16_backward_on_tensor_cores_matches_plain_on_card(cuda, Sq, Sk, D,
                                                             rate):
    """The bf16 backward runs its products on the tensor cores with p.V
    and ds rounded to bf16, as the TPU kernels' ``_dot`` does: a ragged S,
    D = 128 and causal attention with Sk != Sq (offset Sk - Sq), with and
    without dropout. Held at 2^-7 of the largest against the plain
    version with bf16 MXU operands and against the float32 one; a second
    call repeats the first bit for bit (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q, do = (torch.randn(2, Sq, 4, D, device=cuda, generator=g)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(2, Sk, 4, D, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(2))
    words = (31, 32)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True,
                                 dropout_rate=rate, seed_words=words)
    grads = flash_attention_bwd(q, k, v, o, lse, do, dropout_rate=rate,
                                seed_words=words)
    again = flash_attention_bwd(q, k, v, o, lse, do, dropout_rate=rate,
                                seed_words=words)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    for mxu in (torch.bfloat16, None):
        refs = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                         dropout_rate=rate, seed_words=words,
                                         mxu_dtype=mxu)
        for got, ref in zip(grads, refs):
            assert got.dtype == torch.bfloat16
            assert _rel_err(got, ref) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,rate", [(200, 200, 64, 0.0),
                                          (333, 333, 64, 0.1),
                                          (200, 200, 128, 0.1),
                                          (333, 333, 128, 0.0),
                                          (72, 200, 64, 0.1),
                                          (130, 333, 128, 0.1)])
def test_bf16_forward_on_tensor_cores_matches_plain_on_card(cuda, Sq, Sk, D,
                                                            rate):
    """The bf16 forward runs both products on the tensor cores with pv =
    p * keep rounded to bf16, as the TPU kernels' ``_dot`` does: a ragged
    S, D = 128 and causal attention with Sk != Sq (offset Sk - Sq), with
    and without dropout. o within 2^-7 of the largest of the plain
    version with bf16 MXU operands and of the float32 one (the kernel
    rounds p relative to each 64-key tile's running max, the plain
    version relative to the row's max), lse within 1e-4 of both; a
    second call repeats the first bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + 1)
    q = torch.randn(2, Sq, 4, D, device=cuda, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, Sk, 4, D, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(2))
    words = (33, 34)
    before = kernels.FLASH_ATTENTION_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, return_lse=True,
                                 dropout_rate=rate, seed_words=words)
    assert kernels.FLASH_ATTENTION_FWD.launches == before + 1
    again = flash_attention_fwd(q, k, v, return_lse=True,
                                dropout_rate=rate, seed_words=words)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert o.dtype == torch.bfloat16
    for mxu in (torch.bfloat16, None):
        o_ref, lse_ref = flash_attention_plain(q, k, v, True, None, True,
                                               rate, words, mxu_dtype=mxu)
        assert _rel_err(o, o_ref) <= 2.0 ** -7
        assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,causal", [(65, 65, 64, True),
                                            (65, 65, 128, False),
                                            (200, 200, 64, False),
                                            (200, 200, 128, True),
                                            (512, 512, 64, True),
                                            (512, 512, 128, False),
                                            (72, 200, 64, True),
                                            (130, 512, 128, True),
                                            (65, 200, 64, False)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_forward_on_tensor_cores_matches_plain_on_card(cuda, Sq, Sk, D,
                                                           causal, rate):
    """The f32 forward runs both products on the tensor cores by the
    3xTF32 split, P feeding P V as an A fragment in the accumulator's own
    layout: ragged S (partial last tiles), D = 128, causal with Sk != Sq,
    with and without dropout. o within 1e-4 of the float32 plain version
    (chip_smoke.py's TOL["float32"]), lse within 1e-5, both far inside
    what plain TF32 (10 mantissa bits) would give; a second call repeats
    the first bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D + 5)
    q = torch.randn(2, Sq, 4, D, device=cuda, generator=g)
    k, v = (torch.randn(2, Sk, 4, D, device=cuda, generator=g)
            for _ in range(2))
    args = (causal, None, True, rate, (35, 36))
    before = kernels.FLASH_ATTENTION_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, *args)
    again = flash_attention_fwd(q, k, v, *args)
    assert kernels.FLASH_ATTENTION_FWD.launches == before + 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert o.dtype == torch.float32
    o_ref, lse_ref = flash_attention_plain(q, k, v, *args)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_f32_flash_forward_raises_on_unaligned_tensors(cuda):
    """The f32 forward copies rows in 16-byte pieces too: a contiguous f32
    tensor that starts 4 bytes past an aligned address is refused, with
    and without a bias; the autograd entry copies it and runs."""
    buf = torch.randn(2 * 64 * 2 * 64 + 1, device=cuda)
    q = buf[1:].view(2, 64, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bias_fwd(q, q, q, torch.zeros(2, 64, device=cuda))
    o = flash_attention(q, q, q)
    assert torch.equal(o, flash_attention_fwd(q.clone(), q.clone(),
                                              q.clone()))


@pytest.mark.cuda
def test_bf16_flash_forward_raises_on_unaligned_tensors(cuda):
    """The bf16 kernel copies rows in 16-byte pieces: a contiguous bf16
    tensor that starts 2 bytes past an aligned address is refused, with
    and without a bias; the autograd entry copies it and runs."""
    buf = torch.randn(2 * 64 * 2 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = buf[1:].view(2, 64, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bias_fwd(q, q, q, torch.zeros(2, 64, device=cuda))
    o = flash_attention(q, q, q)
    assert torch.equal(o, flash_attention_fwd(q.clone(), q.clone(),
                                              q.clone()))


@pytest.mark.cuda
def test_tiny_trainstep_on_card_launches_every_training_kernel(cuda):
    cfg = gpt_tiny(**SLICE, hidden_dropout_prob=0.1,
                   attention_dropout_prob=0.1)
    m = GPTForPretraining(cfg, device=cuda)
    crit = GPTPretrainingCriterion()

    def loss(layer, ids, labels):
        with auto_cast(level="O1"):
            return crit(layer(ids), labels)

    step = TrainStep(m, loss, AdamW(1e-3, parameters=m.parameters()))
    ids, labels = _batch(cfg.vocab_size)
    kernels.reset_launch_counts()
    losses = [float(step(ids, labels)) for _ in range(2)]
    assert all(math.isfinite(x) for x in losses)
    n = {k["name"]: k["launches"] for k in kernels.kernels()}
    L, drops = cfg.num_layers, 1 + 2 * cfg.num_layers
    assert n == {"flash_attention_fwd": 2 * L, "flash_attention_bwd": 2 * L,
                 "chunked_ce_lse": 2, "chunked_ce_dlogits": 2,
                 "fused_dropout": 2 * 2 * drops,
                 "paged_decode_attention": 0,
                 "flash_attention_bias_fwd": 0,
                 "flash_attention_bias_bwd_dq": 0,
                 "flash_attention_bias_bwd_dkv": 0,
                 "paged_decode_attention_quant": 0, "bgmv": 0,
                 "int8_matmul": 0}


@pytest.mark.cuda
def test_full_width_trainstep_on_card_tracks_the_cpu(cuda):
    """Three float32 TrainStep steps of a 2-layer GPT-2 345M at full
    width with dropout, on the card and on the CPU from the same weights,
    batch and seed: the card runs the kernels, the CPU their plain
    versions, and the loss curves agree to float32 summation order."""
    from paddle_tpu_torch.models import gpt2_medium
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_medium(num_layers=2)
    ids, labels = _batch(cfg.vocab_size, B=2, S=1024, seed=1)
    curves = []
    for dev in (cuda, torch.device("cpu")):
        m = GPTForPretraining(cfg, device="cpu", seed=0).to(dev)
        crit = GPTPretrainingCriterion()
        step = TrainStep(m, lambda layer, i, l: crit(layer(i), l),
                         AdamW(1e-4, parameters=m.parameters(),
                               weight_decay=0.01), seed=2)
        curves.append([float(step(ids, labels)) for _ in range(3)])
    np.testing.assert_allclose(curves[0], curves[1], rtol=1e-6, atol=0)
    assert curves[0][2] < curves[0][0]
