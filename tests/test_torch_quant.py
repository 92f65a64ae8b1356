"""The port's int8 slice (``paddle_tpu_torch``: ``ops.kernels.quant_matmul``,
``nn.quant``, ``slim``, ``inference``) against the JAX package on the
CPU, and the int8 kernel against its plain version on the card.

Kernel level: on the CPU the port's ``int8_matmul`` computes its plain
version (the product in float64, exact, then the float32 epilogue),
which equals the JAX Pallas kernel (run by the Pallas interpreter) bit
for bit, as do the quantizers. Where a JAX layer should reach the
kernel, the test carries the ``pallas`` marker: without
``FLAGS_pallas_interpret`` JAX's CPU ``slim.QuantizedLinear`` takes its
weight-only composition, another computation than on the TPU.

Model level: an aligned tiny BERT (hidden 128, FF 512, 2 layers, 2
heads: every Linear tiles) and its predictors, f32, int8, int8 + bf16
and static PTQ, from the JAX model's weights (``load_jax_weights``,
before quantization and after it for the int8 buffers). ``bert_tiny``
(hidden 64) does not tile and stays the shape-fallback case.

The ``cuda``-marked cases launch the kernel and skip without a card;
they also run where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_quant.py

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quant.py``.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import inference, slim
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.models import (BertForMaskedLM, bert_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import quant_matmul as qm

# every Linear of this BERT tiles (K, N multiples of 128)
ALIGNED = dict(vocab_size=512, hidden_size=128, num_heads=2,
               intermediate_size=512)


def _named(jax_layer):
    return {k: np.asarray(v._data) for k, v in jax_layer.state_dict().items()}


def _half_quanta(rng, shape):
    """Values ``k + 0.5`` with an absmax of exactly 127 in every column
    (scale 1.0), so each one rounds half to even."""
    x = rng.integers(-126, 126, shape).astype(np.float32) + 0.5
    x[0] = 127.0
    return x


# -- 1. the quantizers ------------------------------------------------------------
@pytest.mark.parametrize("kind", ["random", "half-quanta"])
def test_quantizers_match_jax_bit_for_bit(kind):
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas import quant_matmul as jq
    rng = np.random.default_rng(0)
    if kind == "random":
        x = rng.standard_normal((6, 256)).astype(np.float32) * 3
        w = rng.standard_normal((256, 128)).astype(np.float32) * 0.05
    else:
        x = _half_quanta(rng, (6, 256))
        w = _half_quanta(rng, (256, 128))
    wq, ws = qm.quantize_per_channel(torch.from_numpy(w))
    jwq, jws = jq.quantize_per_channel(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    for act in (None, 0.37):
        xq, xs = qm.quantize_per_tensor(torch.from_numpy(x), act)
        jxq, jxs = jq.quantize_per_tensor(jnp.asarray(x), act)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
        assert xq.dtype == torch.int8 and xs.dtype == torch.float32
    if kind == "half-quanta":
        assert np.all(ws.numpy() == 1.0)
        np.testing.assert_array_equal(wq.numpy(), np.round(w))


def test_observer_matches_jax_and_accumulates():
    """The one scale rule: two observe() calls keep the running absmax;
    quantize() on the observed grid; slim's scales and the kernel
    quantizer follow it."""
    from paddle_tpu.nn.quant import PerChannelAbsMaxObserver as JaxObs
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    obs, jobs = tquant.PerChannelAbsMaxObserver(), JaxObs()
    for a in (w, w * 1.5, w * 0.5):
        np.testing.assert_array_equal(obs.observe(a), jobs.observe(a))
    q, s = obs.quantize(w)
    jq_, js = jobs.quantize(w)
    np.testing.assert_array_equal(q, jq_)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(slim._channel_scales(w),
                                  tquant.PerChannelAbsMaxObserver()
                                  .observe(w))
    _, ks = qm.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(ks.numpy(), slim._channel_scales(w))


# -- 2. the int8 product against the Pallas kernel -----------------------------------
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(128, 128), (256, 384)])
@pytest.mark.parametrize("M", [1, 20, 130])
def test_int8_matmul_equals_jax_kernel(M, K, N, out):
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas import quant_matmul as jq
    rng = np.random.default_rng(M * 1000 + K + N)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    ws = (rng.random(N) * 1e-2 + 1e-4).astype(np.float32)
    a_s = np.float32(0.0173)
    ref = jq.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws),
                         jnp.asarray(a_s), out_dtype=getattr(jnp, out))
    got = qm.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                         torch.from_numpy(ws), torch.tensor([a_s]),
                         out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref).astype(np.float32))


def test_int8_matmul_checks_its_arguments():
    z8 = torch.zeros(4, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple|% 128"):
        qm.int8_matmul(torch.zeros(4, 100, dtype=torch.int8),
                       torch.zeros(100, 128, dtype=torch.int8),
                       torch.ones(128), 1.0)
    with pytest.raises(ValueError, match="shapes"):
        qm.int8_matmul(z8, torch.zeros(128, 128, dtype=torch.int8),
                       torch.ones(64), 1.0)
    # an int8 @ on the CPU wraps around in int8: the plain version must not
    big = torch.full((1, 128), 127, dtype=torch.int8)
    acc = qm.int8_matmul(big, big.t().contiguous().repeat(1, 128),
                         torch.ones(128), 1.0)
    assert float(acc[0, 0]) == 128 * 127 * 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_linear_equals_jax(static, dtype):
    """Bias, a 3-D input, a static or dynamic activation scale."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas import quant_matmul as jq
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    act = 0.021 if static else None
    jwq, jws = jq.quantize_per_channel(jnp.asarray(w))
    ref = jq.int8_linear(jnp.asarray(x).astype(getattr(jnp, dtype)), jwq,
                         jws, bias=jnp.asarray(b), act_scale=act)
    wq, ws = qm.quantize_per_channel(torch.from_numpy(w))
    got = qm.int8_linear(torch.from_numpy(x).to(getattr(torch, dtype)), wq,
                         ws, bias=torch.from_numpy(b), act_scale=act)
    assert got.shape == (2, 5, 128) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref).astype(np.float32))


# -- 4. slim.QuantizedLinear ---------------------------------------------------------
def _linear_pair(K, N, seed):
    """A JAX Linear and the port's with the same random weight and bias."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import Linear as JaxLinear
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    jl = JaxLinear(K, N)
    jl.set_state_dict({"weight": paddle.to_tensor(w),
                       "bias": paddle.to_tensor(b)})
    tl = load_jax_weights(Linear(K, N), {"weight": w, "bias": b})
    x = rng.standard_normal((4, 3, K)).astype(np.float32)
    return jl, tl, x


@pytest.mark.pallas
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quantized_linear_aligned_equals_jax_kernel_path(static):
    import paddle_tpu as paddle
    from paddle_tpu import slim as jslim
    jl, tl, x = _linear_pair(256, 128, 3)
    act = 0.05 if static else None
    jq_ = jslim.QuantizedLinear.from_linear(jl, act_scale=act)
    tq = slim.QuantizedLinear.from_linear(tl, act_scale=act)
    np.testing.assert_array_equal(tq.weight_q.numpy(), jq_.weight_q.numpy())
    np.testing.assert_array_equal(tq.scale.numpy(), jq_.scale.numpy())
    assert tq.weight_q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert set(tq.state_dict()) == {"weight_q", "scale", "bias"}
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = tq(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  jq_(paddle.to_tensor(x)).numpy())
    assert kernels.FALLBACKS == {}


@pytest.mark.parametrize("static", [False, True], ids=["weight-only", "static"])
def test_quantized_linear_shape_fallbacks_equal_jax(static):
    """``Linear(64, 48)`` does not tile: the JAX package's weight-only
    composition (f32 matmuls, summed in other orders: 1e-6) or its
    static int8 product (exact in both), counted as a shape fallback."""
    import paddle_tpu as paddle
    from paddle_tpu import slim as jslim
    jl, tl, x = _linear_pair(64, 48, 4)
    act = float(np.abs(x).max() / 127.0) if static else None
    jq_ = jslim.QuantizedLinear.from_linear(jl, act_scale=act)
    tq = slim.QuantizedLinear.from_linear(tl, act_scale=act)
    np.testing.assert_array_equal(tq.weight_q.numpy(), jq_.weight_q.numpy())
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = tq(torch.from_numpy(x)).numpy()
    ref = jq_(paddle.to_tensor(x)).numpy()
    if static:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    assert kernels.FALLBACKS == {("int8_matmul", "shape"): 1}


def test_quantized_linear_holds_its_weight_k_major_with_jax_values():
    """``weight_q`` is ``[K, N]`` with the JAX layer's values, stored
    K-major (the transposed view of a contiguous ``[N, K]``), and the
    state dict keeps the JAX layer's names, shapes and values; a copy
    through ``load_jax_weights`` and a clone keep the layout."""
    from paddle_tpu import slim as jslim
    jl, tl, _ = _linear_pair(256, 128, 6)
    jq_ = jslim.QuantizedLinear.from_linear(jl)
    tq = slim.QuantizedLinear.from_linear(tl)
    assert tq.weight_q.shape == (256, 128)
    assert qm.k_major(tq.weight_q) and not tq.weight_q.is_contiguous()
    ref = _named(jq_)
    sd = tq.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    loaded = slim.QuantizedLinear(np.zeros((256, 128), np.int8),
                                  np.ones(128, np.float32))
    load_jax_weights(loaded, {k: v for k, v in ref.items() if k != "bias"})
    assert qm.k_major(loaded.weight_q) and qm.k_major(sd["weight_q"].clone())
    np.testing.assert_array_equal(loaded.weight_q.numpy(), ref["weight_q"])


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_linear_same_bits_from_k_major_view(static):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32))
    wq, ws = qm.quantize_per_channel(torch.from_numpy(
        (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)))
    view = wq.t().contiguous().t()
    assert qm.k_major(view) and wq.is_contiguous()
    act = 0.03 if static else None
    assert torch.equal(qm.int8_linear(x, view, ws, act_scale=act),
                       qm.int8_linear(x, wq, ws, act_scale=act))


def test_int8_matmul_rejects_a_weight_neither_contiguous_nor_k_major():
    xq = torch.zeros(4, 128, dtype=torch.int8)
    wide = torch.zeros(128, 256, dtype=torch.int8)
    for wq in (wide[:, :128], wide[:, ::2],
               torch.zeros(256, 256, dtype=torch.int8).t()[:128, :128]):
        assert not (qm.k_major(wq) or wq.is_contiguous())
        with pytest.raises(ValueError, match="transposed view"):
            qm.int8_matmul(xq, wq, torch.ones(128), 1.0)


# -- 5. quantize_weights, PTQ, QAT, nn.quant ---------------------------------------
def _bert_pair(cfg_kw, scan=True):
    """The JAX BertForMaskedLM from ``paddle.seed(0)`` and the port's with
    its weights, on the CPU. The JAX PTQ hooks read each input's absmax
    as a Python float, so they need the JAX layer loop (``scan=False``)
    instead of its ``lax.scan``. BERT starts with zero biases; these
    are random, so that every comparison sees where a bias is added."""
    import paddle_tpu as paddle
    from paddle_tpu.models import bert as jbert
    paddle.seed(0)
    jm = jbert.BertForMaskedLM(jbert.bert_tiny(**cfg_kw, scan_layers=scan))
    rng = np.random.default_rng(5)
    jm.set_state_dict({k: (0.1 * rng.standard_normal(v.shape))
                       .astype(np.float32)
                       for k, v in _named(jm).items() if k.endswith("bias")})
    pm = BertForMaskedLM(bert_tiny(**cfg_kw), device="cpu")
    return jm, load_jax_weights(pm, _named(jm))


def _bert_batch(vocab, B=2, S=64, M=6, seed=0):
    """ids, token types, a 0/1 mask with row 1 padded to 40, positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, S)).astype(np.int32)
    tt = np.zeros((B, S), np.int32)
    mask = np.ones((B, S), np.int32)
    ids[1, 40:] = 0
    mask[1, 40:] = 0
    tt[:, S // 2:] = 1
    pos = np.stack([rng.choice(np.arange(1, 40), M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    return ids, tt, mask, pos


@pytest.mark.parametrize("cfg_kw,count", [(ALIGNED, 14), ({}, 14),
                                          (dict(intermediate_size=32), 10)],
                         ids=["aligned", "bert_tiny", "small-ffn"])
def test_quantize_weights_counts_match_jax(cfg_kw, count):
    """Every Linear of at least 4096 weights, in both packages: 2 layers
    x 6 + transform + pooler, the FFN pair dropping out below 4096."""
    from paddle_tpu import slim as jslim
    jm, pm = _bert_pair(cfg_kw)
    assert slim.quantize_weights(pm) == jslim.quantize_weights(jm) == count
    jsd, psd = _named(jm), pm.state_dict()
    assert set(jsd) == set(psd)
    for k, v in jsd.items():
        assert str(psd[k].dtype).replace("torch.", "") == str(v.dtype), k
        if v.dtype == np.int8 or k.endswith(".scale"):
            np.testing.assert_array_equal(psd[k].numpy(), v, err_msg=k)


def test_load_jax_weights_carries_int8_buffers_by_dtype():
    """A quantized JAX Linear's state lands in the port's
    QuantizedLinear as int8 and float32; a float array is never cast
    into an int8 buffer."""
    from paddle_tpu import slim as jslim
    jl, tl, _ = _linear_pair(256, 128, 5)
    jq_ = jslim.QuantizedLinear.from_linear(jl)
    tq = slim.QuantizedLinear(np.zeros((256, 128), np.int8),
                              np.ones(128, np.float32),
                              np.zeros(128, np.float32))
    load_jax_weights(tq, _named(jq_))
    assert tq.weight_q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.weight_q.numpy(), jq_.weight_q.numpy())
    np.testing.assert_array_equal(tq.scale.numpy(), jq_.scale.numpy())
    bad = dict(_named(jq_))
    bad["weight_q"] = bad["weight_q"].astype(np.float32)
    with pytest.raises(TypeError, match="weight_q"):
        load_jax_weights(tq, bad)


@pytest.mark.pallas
def test_ptq_ranges_act_scales_and_outputs_match_jax():
    import paddle_tpu as paddle
    from paddle_tpu import slim as jslim
    jm, pm = _bert_pair(ALIGNED, scan=False)
    jptq = jslim.PostTrainingQuantization(jm)
    tptq = slim.PostTrainingQuantization(pm)
    for seed in (1, 2):
        batch = _bert_batch(ALIGNED["vocab_size"], seed=seed)
        jptq.collect(*batch)
        tptq.collect(*map(torch.from_numpy, batch))
    jnames = {id(m): n for n, m in jm.named_sublayers(include_self=True)}
    tnames = {id(m): n for n, m in pm.named_modules()}
    jr = {jnames[k]: v for k, v in jptq._ranges.items()}
    tr = {tnames[k]: v for k, v in tptq.ranges().items()}
    assert set(tr) == set(jr) and len(tr) == 14
    for n, v in jr.items():
        np.testing.assert_allclose(tr[n], v, rtol=1e-5, err_msg=n)
    jptq.run()
    tptq.run()
    for n, m in pm.named_modules():
        if isinstance(m, slim.QuantizedLinear):
            ref = dict(jm.named_sublayers())[n]
            np.testing.assert_allclose(m.act_scale, ref.act_scale, rtol=1e-5)
            np.testing.assert_array_equal(m.weight_q.numpy(),
                                          ref.weight_q.numpy())
    ids, tt, mask, pos = _bert_batch(ALIGNED["vocab_size"], seed=3)
    ref = jm(*map(paddle.to_tensor, (ids, tt, mask, pos))).numpy()
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, (ids, tt, mask, pos))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())


class _MLP(torch.nn.Module):
    def __init__(self, din=32, dh=64, dout=4):
        super().__init__()
        self.fc1 = Linear(din, dh)
        self.fc2 = Linear(dh, dout)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def test_qat_quantize_train_convert_matches_jax():
    """QAT.quantize, five Adam steps on fake-quantized weights and
    activations, then convert: losses and outputs within 1e-5, the int8
    buffers equal."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu import slim as jslim
    from paddle_tpu.nn import Linear as JaxLinear
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.optimizer import Adam

    class JaxMLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = JaxLinear(32, 64)
            self.fc2 = JaxLinear(64, 4)

        def forward(self, x):
            return self.fc2(JF.relu(self.fc1(x)))

    paddle.seed(4)
    jm = JaxMLP()
    pm = load_jax_weights(_MLP(), _named(jm))
    for q, m in ((jslim.QAT(min_params=1), jm), (slim.QAT(min_params=1), pm)):
        q.quantize(m)
    assert type(pm.fc1).__name__ == type(jm.fc1).__name__ == "_QATLinear"
    x = np.random.default_rng(9).standard_normal((16, 32)).astype(np.float32)
    y = np.zeros((16,), np.int64)
    jo = jopt.Adam(learning_rate=1e-2, parameters=jm.parameters())
    po = Adam(1e-2, parameters=pm.parameters())
    jl, tl = [], []
    for _ in range(5):
        loss = JF.cross_entropy(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss))
        tloss = F.cross_entropy(pm(torch.from_numpy(x)), torch.from_numpy(y))
        tloss.backward()
        po.step()
        po.clear_grad()
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert tl[-1] < tl[0]
    jslim.QAT().convert(jm)
    slim.QAT().convert(pm)
    assert type(pm.fc1) is slim.QuantizedLinear
    for n in ("fc1", "fc2"):
        np.testing.assert_array_equal(getattr(pm, n).weight_q.numpy(),
                                      getattr(jm, n).weight_q.numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jm(paddle.to_tensor(x)).numpy(),
                               atol=1e-5, rtol=0)


def _fake_quant_pairs():
    """(name, JAX layer, port layer) of every nn.quant layer, built from
    the same Linear weights where they wrap one."""
    import paddle_tpu.nn.quant as jquant
    from paddle_tpu.nn import Linear as JaxLinear
    import paddle_tpu as paddle
    paddle.seed(5)
    jlin = JaxLinear(16, 8)
    tlin = load_jax_weights(Linear(16, 8), _named(jlin))
    pairs = [("abs_max", jquant.FakeQuantAbsMax(),
              tquant.FakeQuantAbsMax()),
             ("channel_wise", jquant.FakeQuantChannelWiseAbsMax(quant_axis=1),
              tquant.FakeQuantChannelWiseAbsMax(quant_axis=1)),
             ("moving_average", jquant.FakeQuantMovingAverageAbsMax(),
              tquant.FakeQuantMovingAverageAbsMax()),
             ("ma_scale", jquant.MovingAverageAbsMaxScale(),
              tquant.MovingAverageAbsMaxScale()),
             ("qat_linear", jquant.QuantizedLinear(jlin),
              tquant.QuantizedLinear(tlin)),
             ("ma_output", jquant.MAOutputScaleLayer(jlin),
              tquant.MAOutputScaleLayer(tlin)),
             ("fq_ma_output", jquant.FakeQuantMAOutputScaleLayer(jlin),
              tquant.FakeQuantMAOutputScaleLayer(tlin))]
    return pairs


@pytest.mark.parametrize("idx", range(7), ids=[
    "abs_max", "channel_wise", "moving_average", "ma_scale", "qat_linear",
    "ma_output", "fq_ma_output"])
def test_fake_quant_layers_match_jax(idx):
    """Outputs and EMA buffers after three training forwards, then one
    eval forward that leaves the buffers as they were; the gradient is
    the straight-through one."""
    import paddle_tpu as paddle
    _, jl, tl = _fake_quant_pairs()[idx]
    rng = np.random.default_rng(idx)
    xs = [rng.standard_normal((4, 16)).astype(np.float32) * (1 + i)
          for i in range(4)]

    def buffers(m):
        return {k: np.asarray(v._data if hasattr(v, "_data") else v)
                for k, v in m.state_dict().items()
                if k.endswith("scale") or k.endswith("state")}

    for i, x in enumerate(xs):
        if i == 3:
            jl.eval()
            tl.eval()
        ref = jl(paddle.to_tensor(x)).numpy()
        xt = torch.from_numpy(x).requires_grad_()
        got = tl(xt)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5,
                                   rtol=0)
        jb, tb = buffers(jl), buffers(tl)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_allclose(tb[k].numpy() if hasattr(tb[k], "numpy")
                                       else tb[k], jb[k], rtol=1e-6, err_msg=k)
    if idx < 4:
        got.sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
def test_float_functional_layers_match_jax(op):
    import paddle_tpu as paddle
    import paddle_tpu.nn.quant as jquant
    rng = np.random.default_rng(11)
    a, b = (rng.standard_normal((3, 5)).astype(np.float32) + 2
            for _ in range(2))
    ref = getattr(jquant, op)()(paddle.to_tensor(a), paddle.to_tensor(b))
    got = getattr(tquant, op)()(torch.from_numpy(a), torch.from_numpy(b))
    assert isinstance(getattr(tquant, op)(), tquant.FloatFunctionalLayer)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# -- 6. the predictors on the aligned tiny BERT --------------------------------------
def _jax_predictor(jm, mode, specs, calib=()):
    from paddle_tpu import inference as jinf
    from paddle_tpu import slim as jslim
    if mode == "ptq":
        ptq = jslim.PostTrainingQuantization(jm)
        for b in calib:
            ptq.collect(*b)
        jm = ptq.run()
    cfg = jinf.Config.from_layer(jm, specs)
    if mode in ("int8", "int8+bf16"):
        cfg.enable_int8()
    if mode == "int8+bf16":
        cfg.enable_tpu_bf16()
    return jinf.create_predictor(cfg)


def _port_predictor(pm, mode, specs, calib=(), jm=None):
    """The port's predictor; for PTQ, calibrated on the same batches and
    then given the JAX model's ``act_scale``s: they are attributes, not
    state, and the calibration forwards of the two packages differ in
    their last bits, which flips roundings downstream."""
    if mode == "ptq":
        pm.eval()
        ptq = slim.PostTrainingQuantization(pm)
        for b in calib:
            ptq.collect(*map(torch.from_numpy, b))
        pm = ptq.run()
        jmods = dict(jm.named_sublayers())
        for n, m in pm.named_modules():
            if isinstance(m, slim.QuantizedLinear):
                np.testing.assert_allclose(m.act_scale, jmods[n].act_scale,
                                           rtol=1e-6)
                m.act_scale = jmods[n].act_scale
                m.act_scale_tensor.fill_(m.act_scale)
    cfg = inference.Config.from_layer(pm, specs)
    if mode in ("int8", "int8+bf16"):
        cfg.enable_int8()
    if mode == "int8+bf16":
        cfg.enable_tpu_bf16()
    return inference.create_predictor(cfg)


# tolerance against the JAX predictor, relative to the largest |score|
# (f32: absolute). Quantization is discontinuous: where the packages'
# f32 sums differ in their last bit, an activation may round to the
# other int8 neighbour, and the layers after it carry that quantum. The
# int8 predictors agree to 3.3e-7 on this batch and on five of six
# others (the sixth: one such quantum, 1.67e-2); in bf16 the two
# packages round at other points (bf16 alone: 8.0e-3 to 1.3e-2), and a
# one-ulp difference near an activation's absmax is half a quantum of
# its int8 grid, so about half of them move a full quantum: 2.01e-2 to
# 2.82e-2 over six batches (mean 3.9e-3 to 4.5e-3), 2.73e-2 (mean
# 4.6e-3) on this one, as tools/quant_parity_spread.py measures. That
# spread is as wide as the int8 error itself: the same script reads
# wrong predictors (bf16 without int8, int8 in float32, the bias added
# before the cast to bf16) at 1.93e-2 to 2.64e-2, so no limit here
# tells them from a sound one. The count of QuantizedLinear layers, the
# bf16 outputs of every one of them (below) and the bf16 cases of
# test_int8_linear_equals_jax (bit-equal) do.
PREDICTOR_TOL = {"f32": ("abs", 1e-4), "int8": ("rel", 1e-3),
                 "int8+bf16": ("rel", 4e-2), "ptq": ("rel", 1e-3)}
PREDICTOR_BF16_MEAN_TOL = 6e-3


@pytest.mark.pallas
@pytest.mark.parametrize("mode", list(PREDICTOR_TOL))
def test_predictor_matches_jax_predictor(mode):
    from paddle_tpu.jit.input_spec import InputSpec
    jm, pm = _bert_pair(ALIGNED, scan=mode != "ptq")
    batch = _bert_batch(ALIGNED["vocab_size"])
    specs = [InputSpec(a.shape, "int32") for a in batch]
    calib = [_bert_batch(ALIGNED["vocab_size"], seed=s) for s in (1, 2)]
    jpred = _jax_predictor(jm, mode, specs, calib)
    kernels.reset_launch_counts()
    tpred = _port_predictor(pm, mode, specs, calib, jm)
    out_dtypes = set()
    hooks = [m.register_forward_hook(
        lambda m, args, out: out_dtypes.add(out.dtype))
        for m in pm.modules() if isinstance(m, slim.QuantizedLinear)]
    ref = jpred.run(list(batch))[0]
    got = tpred.run(list(batch))[0]
    for h in hooks:
        h.remove()
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 6, 512)
    kind, tol = PREDICTOR_TOL[mode]
    atol = tol if kind == "abs" else tol * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    if mode == "int8+bf16":
        assert np.abs(got - ref).mean() <= \
            PREDICTOR_BF16_MEAN_TOL * np.abs(ref).max()
    assert out_dtypes == (set() if mode == "f32" else
                          {torch.bfloat16 if mode == "int8+bf16"
                           else torch.float32})
    assert kernels.FALLBACKS == {}
    quantized = [n for n, m in pm.named_modules()
                 if isinstance(m, slim.QuantizedLinear)]
    assert len(quantized) == (0 if mode == "f32" else 14)
    assert not any(type(m) is Linear for m in pm.modules()) \
        or mode == "f32"
    # every parameter of the layer stays float32 (bf16 lives in the
    # predictor's own dict); int8 buffers are carried by name and dtype
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    if mode in ("int8", "int8+bf16"):
        jsd = _named(jm)
        for k, v in pm.state_dict().items():
            if v.dtype == torch.int8:
                np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)
        load_jax_weights(pm, jsd)
        assert pm.bert.encoder.layers[0].linear1.weight_q.dtype == torch.int8
        np.testing.assert_array_equal(tpred.run(list(batch))[0], got)


@pytest.mark.pallas
@pytest.mark.parametrize("mode", ["f32", "int8+bf16"])
def test_predictors_keep_the_weights_they_were_built_with(mode):
    """Both predictors snapshot the layer's parameters and buffers when
    they are built (the bf16 one casts its copy): halving every floating
    tensor and negating every int8 one afterwards leaves both outputs
    bit for bit as they were, still within the parity tolerance of each
    other; a predictor built after the change reads the new weights."""
    from paddle_tpu.jit.input_spec import InputSpec
    jm, pm = _bert_pair(ALIGNED)
    batch = list(_bert_batch(ALIGNED["vocab_size"]))
    specs = [InputSpec(a.shape, "int32") for a in batch]
    jpred = _jax_predictor(jm, mode, specs)
    tpred = _port_predictor(pm, mode, specs)
    ref, got = jpred.run(batch)[0], tpred.run(batch)[0]
    jm.set_state_dict({k: v * 0.5 if v.dtype.kind == "f" else -v
                       for k, v in _named(jm).items()})
    with torch.no_grad():
        for t in (*pm.parameters(), *pm.buffers()):
            if t.is_floating_point():
                t.mul_(0.5)
            elif t.dtype == torch.int8:
                t.neg_()
    np.testing.assert_array_equal(jpred.run(batch)[0], ref)
    np.testing.assert_array_equal(tpred.run(batch)[0], got)
    kind, tol = PREDICTOR_TOL[mode]
    atol = tol if kind == "abs" else tol * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    cfg = inference.Config.from_layer(pm, [a.shape for a in batch])
    assert not np.array_equal(inference.create_predictor(cfg).run(batch)[0],
                              got)


def test_predictor_handles_and_config_surface():
    """The zero-copy handle surface gives what run([arrays]) gives; an
    unset input raises; a model path and save_optimized_model wait for
    jit.save/io."""
    _, pm = _bert_pair(ALIGNED)
    batch = _bert_batch(ALIGNED["vocab_size"])
    cfg = inference.Config.from_layer(pm, [a.shape for a in batch])
    cfg.enable_int8()
    cfg.switch_ir_optim(True)
    cfg.enable_memory_optim()
    cfg.disable_glog_info()
    cfg.set_cpu_math_library_num_threads(2)
    assert "weight_quant: True" in cfg.summary()
    pred = inference.create_predictor(cfg)
    names = pred.get_input_names()
    assert names == ["x0", "x1", "x2", "x3"]
    with pytest.raises(RuntimeError, match="not set"):
        pred.run()
    for n, a in zip(names, batch):
        h = pred.get_input_handle(n)
        assert h.shape() == a.shape
        h.copy_from_cpu(a)
    assert pred.run() is None
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, pred.run(list(batch))[0])
    with pytest.raises(NotImplementedError, match="jit.save"):
        inference.Config("some/model")
    with pytest.raises(NotImplementedError, match="jit.save"):
        pred.save_optimized_model("some/model")


# -- 7. the AMP int8 linear ------------------------------------------------------------
@pytest.mark.pallas
def test_int8_amp_linear_forward_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas import quant_matmul as jq
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    g = rng.standard_normal((2, 5, 128)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, ww, bb: jq.int8_amp_linear(a, ww, bb),
                       *map(jnp.asarray, (x, w, b)))
    rdx, rdw, rdb = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = qm.int8_amp_linear(*ts)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    for t, r in zip(ts, (rdx, rdw, rdb)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(r)).max())


def test_amp_int8_flag_routes_linear_only_under_autocast():
    """With the flag and an autocast region F.linear is the int8 product
    of the bf16 operands; without either it is the plain bf16 or f32
    matmul, bit for bit; a weight that does not tile is counted."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 256)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    with auto_cast():
        plain = F.linear(x, w, b)
        with flag_scope("amp_int8_matmul", True):
            routed = F.linear(x, w, b)
    ref = qm.int8_amp_linear(x.bfloat16(), w.bfloat16(), b.bfloat16())
    torch.testing.assert_close(routed, ref, rtol=0, atol=0)
    torch.testing.assert_close(plain, x.bfloat16() @ w.bfloat16()
                               + b.bfloat16(), rtol=0, atol=0)
    assert not torch.equal(routed, plain)
    with flag_scope("amp_int8_matmul", True):
        torch.testing.assert_close(F.linear(x, w, b), x @ w + b, rtol=0,
                                   atol=0)
        kernels.reset_launch_counts()
        with auto_cast():
            F.linear(x[:, :100], w[:100])
    assert kernels.FALLBACKS == {("int8_matmul", "shape"): 1}


@pytest.mark.pallas
def test_o1_trainstep_with_amp_int8_matches_jax():
    """Two O1 steps of a 128-aligned tiny GPT (its MLP linears tile) with
    the flag on in both packages: losses within 2e-2, the O1 tolerance;
    and not the flag-off losses."""
    import paddle_tpu as paddle
    from paddle_tpu.core.flags import flag_scope as jax_flag_scope
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    cfg_kw = dict(vocab_size=4352, hidden_size=128, num_heads=2)
    rng = np.random.default_rng(0)
    ids, labels = (rng.integers(0, 4352, (2, 64)).astype(np.int32)
                   for _ in range(2))
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**cfg_kw))
    named = _named(jm)
    jcrit, crit = JaxCrit(), GPTPretrainingCriterion()

    def jloss(layer, a, b):
        with paddle.amp.auto_cast(level="O1"):
            return jcrit(layer(a), b)

    def tloss(layer, a, b):
        with auto_cast(level="O1"):
            return crit(layer(a), b)

    with jax_flag_scope("amp_int8_matmul", True):
        jstep = JaxTrainStep(jm, jloss, JaxAdamW(
            learning_rate=1e-4, parameters=jm.parameters(),
            weight_decay=0.01))
        jl = [float(jstep(ids, labels)) for _ in range(2)]
    losses = {}
    for flag in (True, False):
        pm = load_jax_weights(GPTForPretraining(gpt_tiny(**cfg_kw),
                                                device="cpu"), named)
        step = TrainStep(pm, tloss, AdamW(1e-4, parameters=pm.parameters(),
                                          weight_decay=0.01))
        with flag_scope("amp_int8_matmul", flag):
            losses[flag] = [float(step(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(losses[True], jl, atol=2e-2, rtol=0)
    assert all(math.isfinite(x) for x in losses[True])
    assert losses[True] != losses[False]


# -- 8. the serving engine entry --------------------------------------------------------
def test_create_serving_engine_int8_quantizes_no_gpt_layer():
    import paddle_tpu as paddle
    from paddle_tpu import slim as jslim
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    from paddle_tpu_torch.serving import ServingConfig
    paddle.seed(0)
    assert jslim.quantize_weights(JaxGPT(jax_gpt_tiny())) == 0
    gpt = GPTForPretraining(gpt_tiny(), device="cpu")
    assert slim.quantize_weights(gpt) == 0
    cfg = inference.Config.from_layer(gpt, [])
    cfg.enable_int8()
    sc = ServingConfig(max_batch_slots=2, block_size=4, max_context_len=64,
                       prefill_buckets=(8, 16), batch_buckets=(1, 2))
    eng = inference.create_serving_engine(cfg, sc, device="cpu")
    out = eng.generate([[3, 4, 5]], max_new_tokens=2)
    assert len(out[0]) == 5
    cfg.enable_tpu_bf16()
    with pytest.raises(NotImplementedError, match="float32"):
        inference.create_serving_engine(cfg, sc, device="cpu")


# -- 9. the kernel on the card -------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 128, 128), (48, 768, 768),
                                   (130, 256, 384), (300, 3072, 768),
                                   (257, 768, 3072)])
def test_int8_matmul_bit_equal_to_plain_on_card(cuda, M, K, N, out):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    xq = torch.randint(-127, 128, (M, K), device=cuda, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    ws = torch.rand(N, device=cuda, generator=g) * 1e-2 + 1e-4
    act = torch.tensor([0.0173], device=cuda)
    before = kernels.INT8_MATMUL.launches
    got = qm.int8_matmul(xq, wq, ws, act, out_dtype=out)
    assert kernels.INT8_MATMUL.launches == before + 1
    ref = qm.int8_matmul_plain(xq, wq, ws, act, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "k_major"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 63, 65, 130, 24577])
def test_int8_matmul_tile_edges_and_weight_layouts_on_card(cuda, M, out,
                                                           layout):
    """M off the 128-row tile (TMA's zero fill, masked stores) at K =
    3072, w_q as a contiguous [K, N] (the wrapper's K-major copy,
    counted) and as the K-major view (no copy): bit-equal to the plain
    version either way."""
    K, N = 3072, 768
    g = torch.Generator(device=cuda).manual_seed(M)
    xq = torch.randint(-127, 128, (M, K), device=cuda, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    if layout == "k_major":
        wq = wq.t().contiguous().t()
    ws = torch.rand(N, device=cuda, generator=g) * 1e-2 + 1e-4
    act = torch.tensor([0.0173], device=cuda)
    before, copies = kernels.INT8_MATMUL.launches, qm.layout_copies
    got = qm.int8_matmul(xq, wq, ws, act, out_dtype=out)
    assert kernels.INT8_MATMUL.launches == before + 1
    assert qm.layout_copies == copies + (layout == "contiguous")
    ref = qm.int8_matmul_plain(xq, wq, ws, act, out_dtype=out)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == out
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_quantized_paths_on_card_launch_the_kernel(cuda):
    """int8_linear (dynamic and static), the AMP linear and its
    backward, and a predictor over the aligned tiny BERT: every tiling
    Linear launches the kernel once, the shape fallback never."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 7, 256))
                         .astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.05)
                         .astype(np.float32)).to(cuda)
    wq, ws = qm.quantize_per_channel(w)
    kernels.reset_launch_counts()
    for act in (None, torch.tensor([0.02], device=cuda)):
        got = qm.int8_linear(x, wq, ws, act_scale=act)
        xq, a_s = qm.quantize_per_tensor(x.reshape(-1, 256), act)
        ref = qm.int8_matmul_plain(xq, wq, ws, a_s).reshape(3, 7, 128)
        assert torch.equal(got, ref)
    xg = x.clone().requires_grad_()
    wg = w.clone().requires_grad_()
    qm.int8_amp_linear(xg, wg).sum().backward()
    torch.testing.assert_close(xg.grad, torch.ones(3, 7, 128, device=cuda)
                               @ w.t(), rtol=1e-5, atol=1e-5)
    assert kernels.INT8_MATMUL.launches == 3
    m = BertForMaskedLM(bert_tiny(**ALIGNED), device=cuda)
    batch = _bert_batch(ALIGNED["vocab_size"])
    cfg = inference.Config.from_layer(m, [a.shape for a in batch])
    cfg.enable_int8()
    pred = inference.create_predictor(cfg)
    kernels.reset_launch_counts()
    out = pred.run(list(batch))[0]
    assert np.isfinite(out).all() and out.shape == (2, 6, 512)
    assert kernels.INT8_MATMUL.launches == 14
    assert kernels.FLASH_ATTENTION_BIAS_FWD.launches == 2
    assert kernels.FALLBACKS == {}
