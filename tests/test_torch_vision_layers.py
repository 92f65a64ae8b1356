"""The port's vision ops and layers against the JAX package on the CPU.

Convolutions (1/2/3-D and their transposes, stride, int / string /
per-side padding, dilation, groups), every pool (``ceil_mode``,
``exclusive``, adaptive bins that do not divide), ``batch_norm`` in
training and evaluation with the running statistics after three calls,
``fused_conv_bn`` against the unfused chain, an AMP O1 conv -> BN -> ReLU
chain in bf16, and the channels-last layouts (``NHWC`` data formats and
``torch.channels_last`` memory) against NCHW. The same inputs, made by
numpy from a seed, go through both packages; the JAX vision ops reach
no Pallas kernel, so they run as the JAX package's own tests run them.
Tolerances: float32 outputs and gradients within 1e-5 (relative to the
largest magnitude, summation order only); bf16 within 2^-7 of the
largest output (one bf16 rounding of values summed in other orders).

The ``cuda``-marked cases run the ops on the card against the same ops
on the CPU (no JAX there: ``python -m pytest --noconftest -m cuda
tests/test_torch_vision_layers.py``) and skip here.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.amp import auto_cast

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_run(name, arrays, kw, cot, amp=False):
    """The JAX op on ``arrays`` (all differentiable); returns the output
    and the gradients of ``sum(out * cot)``."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    ctx = paddle.amp.auto_cast(level="O1") if amp else _null()
    with ctx:
        out = getattr(JF, name)(*ts, **kw)
    loss = (out.astype("float32") * paddle.to_tensor(cot)).sum()
    loss.backward()
    return (np.asarray(out.astype("float32")._data),
            [np.asarray(t.grad._data) for t in ts])


def _torch_run(name, arrays, kw, cot, amp=False, device="cpu"):
    ts = [torch.tensor(a, device=device, requires_grad=True) for a in arrays]
    ctx = auto_cast(level="O1") if amp else _null()
    with ctx:
        out = getattr(TF, name)(*ts, **kw)
    (out.float() * torch.tensor(cot, device=device)).sum().backward()
    return (out.float().detach().cpu().numpy(),
            [t.grad.cpu().numpy() for t in ts])


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _parity(name, arrays, kw, tol=F32_TOL, grads=True):
    out_t, _ = _torch_run(name, arrays, kw, np.zeros(1, np.float32))
    cot = _rand(out_t.shape, 99)
    out_j, g_j = _jax_run(name, arrays, kw, cot)
    out_t, g_t = _torch_run(name, arrays, kw, cot)
    assert out_t.shape == out_j.shape, (out_t.shape, out_j.shape)
    assert _rel(out_t, out_j) < tol, f"{name} {kw}: output"
    if grads:
        for i, (a, b) in enumerate(zip(g_t, g_j)):
            assert _rel(a, b) < tol, f"{name} {kw}: gradient {i}"


# -- convolutions ------------------------------------------------------------
CONV_CASES = [
    ("conv1d", (2, 4, 9), (6, 2, 3), dict(stride=2, padding=1, groups=2)),
    ("conv1d", (2, 9, 4), (6, 4, 3),
     dict(padding="SAME", dilation=2, data_format="NLC")),
    ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=1)),
    ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3),
     dict(stride=2, padding="SAME", dilation=2)),
    ("conv2d", (2, 4, 9, 8), (6, 2, 3, 3), dict(padding="VALID", groups=2)),
    ("conv2d", (2, 4, 9, 8), (6, 4, 3, 2),
     dict(stride=(2, 1), padding=[[1, 0], [2, 1]])),
    ("conv2d", (2, 9, 8, 4), (6, 4, 3, 3),
     dict(stride=2, padding=1, data_format="NHWC")),
    ("conv3d", (1, 2, 5, 6, 5), (3, 2, 3, 3, 3),
     dict(stride=(1, 2, 1), padding=1)),
    ("conv1d_transpose", (2, 4, 7), (4, 3, 3),
     dict(stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=1)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 2, 3, 3),
     dict(stride=2, groups=2, dilation=2)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding="SAME")),
    ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 3, 2, 2, 2), dict(stride=2)),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
@pytest.mark.parametrize("bias", [False, True])
def test_conv_matches_jax(case, bias):
    name, xs, ws, kw = CONV_CASES[case]
    arrays = [_rand(xs, case), _rand(ws, case + 50) * 0.3]
    if bias:
        out_c = ws[1] * kw.get("groups", 1) if "transpose" in name \
            else ws[0]
        arrays.append(_rand((out_c,), case + 70))
    _parity(name, arrays, kw)


def test_conv_transpose_string_padding_is_zero_padding():
    x, w = _rand((1, 2, 5, 5), 1), _rand((2, 3, 3, 3), 2)
    a = TF.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                            padding="SAME")
    b = TF.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                            padding=0)
    assert torch.equal(a, b) and a.shape == (1, 3, 11, 11)


def test_conv_layers_keep_the_jax_names_and_init():
    conv = tnn.Conv2D(4, 6, 3, groups=2, bias_attr=False)
    assert [k for k, _ in conv.named_parameters()] == ["weight"]
    assert tuple(conv.weight.shape) == (6, 2, 3, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(2 * 9)
    assert conv.weight.abs().max() <= bound and conv.weight.std() > 0
    t = tnn.Conv2DTranspose(4, 6, 3, groups=2)
    assert tuple(t.weight.shape) == (4, 3, 3, 3)
    assert tuple(t.bias.shape) == (6,)


# -- pools -------------------------------------------------------------------
POOL_CASES = [
    ("max_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=2, stride=2,
                                      ceil_mode=True)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("max_pool2d", (2, 3, 6, 6), dict(kernel_size=3, stride=1, padding=2)),
    ("max_pool2d", (2, 9, 8, 3), dict(kernel_size=3, stride=2, padding=1,
                                      data_format="NHWC")),
    ("max_pool3d", (1, 2, 5, 6, 5), dict(kernel_size=2, stride=2)),
    ("avg_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2, padding=1,
                                   exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                      divisor_override=4)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=2, stride=2,
                                      ceil_mode=True)),
    ("avg_pool2d", (2, 3, 7, 7), dict(kernel_size=3, stride=1, padding=2)),
    ("avg_pool3d", (1, 2, 5, 6, 5), dict(kernel_size=3, stride=2,
                                         padding=1)),
    ("adaptive_avg_pool1d", (2, 3, 9), dict(output_size=4)),
    ("adaptive_avg_pool2d", (2, 3, 9, 8), dict(output_size=(3, 5))),
    ("adaptive_avg_pool2d", (2, 3, 7, 7), dict(output_size=(1, 1))),
    ("adaptive_avg_pool2d", (2, 3, 1, 1), dict(output_size=7)),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 5), dict(output_size=(2, 4, 3))),
    ("adaptive_max_pool1d", (2, 3, 9), dict(output_size=4)),
    ("adaptive_max_pool2d", (2, 3, 9, 8), dict(output_size=(3, 5))),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 5), dict(output_size=(2, 4, 3))),
]


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool_matches_jax(case):
    name, xs, kw = POOL_CASES[case]
    _parity(name, [_rand(xs, case)], kw)


def test_pool_layers_run_their_functions():
    x = torch.tensor(_rand((2, 3, 9, 8), 5))
    assert torch.equal(tnn.MaxPool2D(3, 2, 1)(x),
                       TF.max_pool2d(x, 3, 2, 1))
    assert torch.equal(tnn.AvgPool2D(3, 2, 1, exclusive=False)(x),
                       TF.avg_pool2d(x, 3, 2, 1, exclusive=False))
    assert torch.equal(tnn.AdaptiveAvgPool2D((3, 5))(x),
                       TF.adaptive_avg_pool2d(x, (3, 5)))
    assert torch.equal(tnn.AdaptiveMaxPool1D(4)(x[:, :, 0]),
                       TF.adaptive_max_pool1d(x[:, :, 0], 4))


# -- batch norm ----------------------------------------------------------------
def _jax_bn_calls(xs, w, b, rm, rv, training, kw):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor
    rm_t, rv_t = Tensor(rm.copy()), Tensor(rv.copy())
    outs = []
    for i, x in enumerate(xs):
        xt = paddle.to_tensor(x, stop_gradient=False)
        wt = paddle.to_tensor(w, stop_gradient=False)
        bt = paddle.to_tensor(b, stop_gradient=False)
        y = JF.batch_norm(xt, rm_t, rv_t, wt, bt, training=training, **kw)
        (y * paddle.to_tensor(_rand(x.shape, 40 + i))).sum().backward()
        outs.append((np.asarray(y._data), np.asarray(xt.grad._data),
                     np.asarray(wt.grad._data), np.asarray(bt.grad._data),
                     np.asarray(rm_t._data).copy(),
                     np.asarray(rv_t._data).copy()))
    return outs


def _torch_bn_calls(xs, w, b, rm, rv, training, kw, device="cpu"):
    rm_t = torch.tensor(rm, device=device)
    rv_t = torch.tensor(rv, device=device)
    outs = []
    for i, x in enumerate(xs):
        xt = torch.tensor(x, device=device, requires_grad=True)
        wt = torch.tensor(w, device=device, requires_grad=True)
        bt = torch.tensor(b, device=device, requires_grad=True)
        y = TF.batch_norm(xt, rm_t, rv_t, wt, bt, training=training, **kw)
        (y * torch.tensor(_rand(x.shape, 40 + i), device=device)).sum() \
            .backward()
        outs.append(tuple(t.detach().cpu().numpy().copy() for t in
                          (y, xt.grad, wt.grad, bt.grad, rm_t, rv_t)))
    return outs


BN_CASES = [((4, 6, 5, 5), {}), ((8, 6), {}),
            ((4, 5, 5, 6), dict(data_format="NHWC")),
            ((3, 6, 4, 3, 2), dict(momentum=0.8, epsilon=1e-3))]


@pytest.mark.parametrize("case", range(len(BN_CASES)))
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax_with_running_stats(case, training):
    """Three calls; in training the running statistics follow the JAX
    ``m * old + (1 - m) * batch`` update with the biased variance, to
    float32 rounding (the batch mean and variance are sums in another
    order)."""
    shape, kw = BN_CASES[case]
    C = shape[-1] if kw.get("data_format") == "NHWC" else shape[1]
    xs = [_rand(shape, case * 10 + i) * (1 + i) + i for i in range(3)]
    w, b = _rand((C,), 7) + 1.0, _rand((C,), 8)
    rm = _rand((C,), 9) if not training else np.zeros(C, np.float32)
    rv = (np.abs(_rand((C,), 10)) + 0.5) if not training \
        else np.ones(C, np.float32)
    want = _jax_bn_calls(xs, w, b, rm, rv, training, kw)
    got = _torch_bn_calls(xs, w, b, rm, rv, training, kw)
    for call, (g, j) in enumerate(zip(got, want)):
        for what, a, e in zip(("out", "dx", "dw", "db"), g[:4], j[:4]):
            assert _rel(a, e) < F32_TOL, f"call {call}: {what}"
        np.testing.assert_allclose(g[4], j[4], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g[5], j[5], rtol=1e-6, atol=1e-6)
    if training:        # the stats moved, by the JAX formula
        assert not np.allclose(got[-1][5], 1.0)


def test_batch_norm_use_global_stats_normalises_by_running_stats():
    x = torch.tensor(_rand((4, 3, 5, 5), 1))
    rm, rv = torch.tensor([0.5, -1.0, 2.0]), torch.tensor([1.0, 4.0, 0.25])
    y = TF.batch_norm(x, rm.clone(), rv.clone(), training=True,
                      use_global_stats=True)
    ref = TF.batch_norm(x, rm, rv, training=False)
    assert torch.equal(y, ref)


def test_batch_norm_layer_names_and_buffers():
    bn = tnn.BatchNorm2D(6)
    assert sorted(bn.state_dict()) == ["_mean", "_variance", "bias",
                                       "weight"]
    assert torch.equal(bn._variance, torch.ones(6))
    assert [k for k, _ in bn.named_parameters()] == ["weight", "bias"]
    x = torch.tensor(_rand((4, 6, 3, 3), 2))
    bn(x)
    assert not torch.equal(bn._mean, torch.zeros(6))
    bn.eval()
    assert torch.equal(bn(x), TF.batch_norm(x, bn._mean, bn._variance,
                                            bn.weight, bn.bias))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_fused_conv_bn_matches_unfused_and_jax(training, act):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor
    x, w = _rand((2, 3, 8, 8), 1), _rand((6, 3, 3, 3), 2) * 0.3
    g, b = _rand((6,), 3) + 1.0, _rand((6,), 4)
    rm, rv = np.zeros(6, np.float32), np.ones(6, np.float32)
    xt = torch.tensor(x)
    stats = [torch.tensor(rm), torch.tensor(rv)]
    fused = TF.fused_conv_bn(xt, torch.tensor(w), None, *stats,
                             torch.tensor(g), torch.tensor(b), padding=1,
                             training=training, activation=act)
    ref_stats = [torch.tensor(rm), torch.tensor(rv)]
    ref = TF.batch_norm(TF.conv2d(xt, torch.tensor(w), padding=1),
                        *ref_stats, torch.tensor(g), torch.tensor(b),
                        training=training)
    ref = {None: ref, "relu": TF.relu(ref), "relu6": TF.relu6(ref)}[act]
    assert torch.equal(fused, ref)
    assert all(torch.equal(a, c) for a, c in zip(stats, ref_stats))
    jrm, jrv = Tensor(rm.copy()), Tensor(rv.copy())
    j = JF.fused_conv_bn(paddle.to_tensor(x), paddle.to_tensor(w), None,
                         jrm, jrv, paddle.to_tensor(g), paddle.to_tensor(b),
                         padding=1, training=training, activation=act)
    assert _rel(fused.numpy(), np.asarray(j._data)) < F32_TOL
    np.testing.assert_allclose(stats[1].numpy(), np.asarray(jrv._data),
                               rtol=1e-6)


def test_o1_conv_bn_relu_chain_in_bf16():
    """Under AMP O1 the conv runs in bf16, BN keeps its input's dtype (no
    cast) and its running statistics stay f32: the chain's output is bf16
    within one rounding of the JAX chain's, the statistics within bf16
    resolution of the batch (taken from the bf16 conv output)."""
    x, w = _rand((4, 3, 10, 10), 1), _rand((8, 3, 3, 3), 2) * 0.3
    g, b = _rand((8,), 3) + 1.0, _rand((8,), 4)
    cot = _rand((4, 8, 10, 10), 5)

    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor
    jx, jw = paddle.to_tensor(x, stop_gradient=False), \
        paddle.to_tensor(w, stop_gradient=False)
    jrm, jrv = Tensor(np.zeros(8, np.float32)), Tensor(np.ones(8, np.float32))
    with paddle.amp.auto_cast(level="O1"):
        jy = JF.relu(JF.batch_norm(JF.conv2d(jx, jw, padding=1), jrm, jrv,
                                   paddle.to_tensor(g), paddle.to_tensor(b),
                                   training=True))
    (jy.astype("float32") * paddle.to_tensor(cot)).sum().backward()

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    trm, trv = torch.zeros(8), torch.ones(8)
    with auto_cast(level="O1"):
        ty = TF.relu(TF.batch_norm(TF.conv2d(tx, tw, padding=1), trm, trv,
                                   torch.tensor(g), torch.tensor(b),
                                   training=True))
    assert ty.dtype == torch.bfloat16 and str(jy.dtype).endswith("bfloat16")
    assert trm.dtype == torch.float32
    (ty.float() * torch.tensor(cot)).sum().backward()
    assert _rel(ty.float().detach().numpy(),
                np.asarray(jy.astype("float32")._data)) < BF16_TOL
    np.testing.assert_allclose(trm.numpy(), np.asarray(jrm._data),
                               rtol=BF16_TOL, atol=1e-3)
    np.testing.assert_allclose(trv.numpy(), np.asarray(jrv._data),
                               rtol=BF16_TOL, atol=1e-3)
    assert _rel(tw.grad.numpy(), np.asarray(jw.grad._data)) < 4 * BF16_TOL
    assert _rel(tx.grad.numpy(), np.asarray(jx.grad._data)) < 4 * BF16_TOL


# -- layouts -------------------------------------------------------------------
def _chain(x, w, data_format, stats):
    y = TF.conv2d(x, w, padding=1, stride=2, data_format=data_format)
    y = TF.batch_norm(y, *stats, training=True, data_format=data_format)
    y = TF.max_pool2d(TF.relu(y), 3, 2, 1, data_format=data_format)
    return TF.adaptive_avg_pool2d(y, (2, 3), data_format=data_format)


def test_nhwc_data_format_matches_nchw():
    x, w = _rand((2, 3, 16, 14), 1), _rand((8, 3, 3, 3), 2)
    s1 = [torch.zeros(8), torch.ones(8)]
    s2 = [torch.zeros(8), torch.ones(8)]
    ref = _chain(torch.tensor(x), torch.tensor(w), "NCHW", s1)
    got = _chain(torch.tensor(x).permute(0, 2, 3, 1), torch.tensor(w),
                 "NHWC", s2)
    assert _rel(got.permute(0, 3, 1, 2).numpy(), ref.numpy()) < F32_TOL
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_channels_last_memory_format_matches_contiguous():
    """A channels-last input keeps its format through the chain (cuDNN's
    and the CPU's NHWC kernels) and gives the contiguous input's
    numbers; flatten sees the logical NCHW order."""
    x, w = _rand((2, 3, 16, 14), 1), _rand((8, 3, 3, 3), 2)
    s1 = [torch.zeros(8), torch.ones(8)]
    s2 = [torch.zeros(8), torch.ones(8)]
    ref = _chain(torch.tensor(x), torch.tensor(w), "NCHW", s1)
    xcl = torch.tensor(x).contiguous(memory_format=torch.channels_last)
    y = TF.conv2d(xcl, torch.tensor(w), padding=1)
    assert tnn.layout.is_channels_last(y)
    got = _chain(xcl, torch.tensor(w), "NCHW", s2)
    assert _rel(got.numpy(), ref.numpy()) < F32_TOL
    assert torch.equal(TF.flatten(got, 1), TF.flatten(got.contiguous(), 1))


def test_check_data_format():
    assert tnn.layout.check_data_format("NHWC") == "NHWC"
    with pytest.raises(ValueError, match="NCHW"):
        tnn.layout.check_data_format("NCL")


# -- the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv_on_card_is_f32_whatever_the_tf32_flag(cuda, case):
    """The f32 conv and its gradients on the card within 1e-5 of the CPU,
    and the same bits with ``cudnn.allow_tf32`` on as off."""
    name, xs, ws, kw = CONV_CASES[case]
    arrays = [_rand(xs, case), _rand(ws, case + 50) * 0.3]
    cot = _rand(_torch_run(name, arrays, kw, np.zeros(1, np.float32))[0]
                .shape, 99)
    ref, g_ref = _torch_run(name, arrays, kw, cot)
    prev = torch.backends.cudnn.allow_tf32
    runs = []
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            runs.append(_torch_run(name, arrays, kw, cot, device=cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (on, g_on), (off, g_off) = runs
    assert _rel(off, ref) < F32_TOL
    for a, b in zip(g_off, g_ref):
        assert _rel(a, b) < F32_TOL
    np.testing.assert_array_equal(on, off)


@pytest.mark.cuda
def test_conv_threads_leave_the_tf32_flag_as_they_found_it(cuda):
    """Float32 convs (forward and backward) from four threads at once:
    each forward gives the bits of a lone run and each gradient is within
    ``F32_TOL`` of it (a weight gradient may sum in another order), and
    the user's ``allow_tf32`` is what it was before."""
    import threading
    name, xs, ws, kw = CONV_CASES[2]
    arrays = [_rand(xs, 0), _rand(ws, 50) * 0.3]
    cot = _rand(_torch_run(name, arrays, kw, np.zeros(1, np.float32))[0]
                .shape, 99)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        want, g_want = _torch_run(name, arrays, kw, cot, device=cuda)
        bad = []

        def work():
            for _ in range(20):
                got, g_got = _torch_run(name, arrays, kw, cot, device=cuda)
                if not (np.array_equal(got, want) and all(
                        _rel(a, b) < F32_TOL for a, b in zip(g_got, g_want))):
                    bad.append(1)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert torch.backends.cudnn.allow_tf32 is True
        assert not bad
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool_on_card_matches_cpu(cuda, case):
    name, xs, kw = POOL_CASES[case]
    x = [_rand(xs, case)]
    cot = _rand(_torch_run(name, x, kw, np.zeros(1, np.float32))[0].shape, 9)
    ref, g_ref = _torch_run(name, x, kw, cot)
    got, g_got = _torch_run(name, x, kw, cot, device=cuda)
    assert _rel(got, ref) < F32_TOL and _rel(g_got[0], g_ref[0]) < F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_batch_norm_on_card_matches_cpu(cuda, case):
    shape, kw = BN_CASES[case]
    C = shape[-1] if kw.get("data_format") == "NHWC" else shape[1]
    xs = [_rand(shape, case * 10 + i) for i in range(3)]
    w, b = _rand((C,), 7) + 1.0, _rand((C,), 8)
    rm, rv = np.zeros(C, np.float32), np.ones(C, np.float32)
    ref = _torch_bn_calls(xs, w, b, rm, rv, True, kw)
    got = _torch_bn_calls(xs, w, b, rm, rv, True, kw, device=cuda)
    for g, r in zip(got, ref):
        for a, e in zip(g, r):
            assert _rel(a, e) < F32_TOL
