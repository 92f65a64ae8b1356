"""The port's vision models against the JAX package on the CPU.

Every zoo model has the JAX state-dict keys and shapes and takes a JAX
model's arrays through ``load_jax_weights`` strictly; LeNet trains three
eager Momentum steps and ResNet-18 two float32 ``TrainStep`` steps (with
``FLAGS_jit_channels_last`` on and off) beside the JAX package from the
same weights and batch; ResNet-50's forward and backward, VGG-11's and
MobileNetV2's evaluation forwards and ``inference.passes.fold_conv_bn``
are held to it too. Tolerances: losses within 1e-5 relative; parameters
and BN buffers after the steps within 1e-5 of their largest magnitude
(per tensor); ResNet-50's gradients through its 53 stacked batch norms
per tensor within ``R50_GRAD_L2_TOL`` (L2-relative).

The ``cuda``-marked case trains ResNet-18 on the card beside the CPU
(``python -m pytest --noconftest -m cuda tests/test_torch_vision_models.py``)
and skips here.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.flags import flag_scope
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_jax_weights
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as TM

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
# a parameter that starts at 0 (a BN bias) holds only its updates, whose
# gradient is small by cancellation: its f32 noise is absolute
PARAM_FLOOR = 1e-7
# ResNet-50's per-tensor gradients, L2-relative, at a point where float32
# is well conditioned (test_resnet50_forward_backward_matches_jax): the
# two packages' float32 sums in other orders, about 1e-5 apart there,
# and under a convolution gradient from TF32 products (chip_smoke.py's
# phase 22 (c) prints PyTorch's own beside its 2e-4 limit)
R50_GRAD_L2_TOL = 2e-4
# the last BN's gamma of every bottleneck at that point
R50_BRANCH_GAMMA = 0.25


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_model(name, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.vision import models as JM
    paddle.seed(0)
    return getattr(JM, name)(**kw)


def _arrays(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _pair(name, **kw):
    """A JAX model and the port's on the CPU with its weights."""
    jm = _jax_model(name, **kw)
    tm = getattr(TM, name)(device="cpu", **kw)
    load_jax_weights(tm, _arrays(jm))
    return jm, tm


def _max_rel(a, b, floor=0.0) -> float:
    """Largest difference over ``b``'s largest magnitude; differences
    under ``floor`` (absolute) count as none."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.maximum(np.abs(a - b) - floor, 0.0)
    return float(d.max() / max(np.abs(b).max(), 1e-12))


ZOO = [("LeNet", {}), ("resnet18", dict(num_classes=10)),
       ("resnet34", dict(num_classes=10)), ("resnet50", dict(num_classes=10)),
       ("resnet101", dict(num_classes=10)),
       ("resnet152", dict(num_classes=10)), ("vgg11", dict(num_classes=0)),
       ("vgg13", dict(num_classes=0)), ("vgg16", dict(num_classes=0)),
       ("vgg19", dict(num_classes=0)),
       ("vgg11", dict(num_classes=0, batch_norm=True)),
       ("mobilenet_v1", dict(scale=0.25, num_classes=10)),
       ("mobilenet_v2", dict(scale=0.25, num_classes=10))]


@pytest.mark.parametrize("case", range(len(ZOO)))
def test_zoo_keys_shapes_and_strict_load(case):
    name, kw = ZOO[case]
    jm, tm = _pair(name, **kw)
    want = {k: tuple(v.shape) for k, v in _arrays(jm).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    for k, v in _arrays(jm).items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), v)


def test_vgg_classifier_keys():
    """The classifier (left out of the zoo case above for its 25088 x 4096
    weight) has the JAX names and ``[in, out]`` layouts."""
    m = TM.vgg11(num_classes=7, device="cpu")
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()
           if k.startswith("classifier")}
    assert got == {"classifier.0.weight": (25088, 4096),
                   "classifier.0.bias": (4096,),
                   "classifier.3.weight": (4096, 4096),
                   "classifier.3.bias": (4096,),
                   "classifier.6.weight": (4096, 7),
                   "classifier.6.bias": (7,)}


def test_bias_attr_false_has_no_bias_key():
    keys = TM.resnet18(device="cpu").state_dict()
    assert "conv1.weight" in keys and "conv1.bias" not in keys
    assert "bn1._mean" in keys and "bn1._variance" in keys
    assert tuple(keys["fc.weight"].shape) == (512, 1000)


def test_lenet_eager_momentum_steps_match_jax():
    """BASELINE config 1's loop (B = 64, Momentum(0.01), cross_entropy,
    backward, step, clear_grad), three steps."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.optimizer import Momentum as JMomentum
    jm, tm = _pair("LeNet")
    x = _rand((64, 1, 28, 28), 0)
    y = (np.arange(64) % 10).astype(np.int64)
    jopt = JMomentum(learning_rate=0.01, parameters=jm.parameters())
    topt = Momentum(learning_rate=0.01, parameters=tm.parameters())
    for i in range(3):
        jl = JF.cross_entropy(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = TF.cross_entropy(tm(torch.tensor(x)), torch.tensor(y))
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
    got = tm.state_dict()
    for k, v in _arrays(jm).items():
        assert _max_rel(got[k].numpy(), v, PARAM_FLOOR) < PARAM_TOL, k


def _ce(layer, xb, yb):
    return TF.cross_entropy(layer(xb), yb)


def test_resnet18_trainstep_matches_jax():
    """Two float32 ``TrainStep`` steps at [2, 3, 64, 64] (the JAX
    package's own ResNet-18 step test's shape), the port with
    ``FLAGS_jit_channels_last`` on and off: losses, parameters and the
    BN running statistics. (At 32 x 32 the last stage's BNs normalise
    two values a channel, whose difference cancels: the first loss then
    moves by 4e-4 between the port's own two layouts, and the second
    step by tens of percent, so no f32 comparison is meaningful there.
    At lr 0.005 one step fits the two images and the second loss falls
    to 0.1, where 2.5e-6 of f32 noise is 2e-5 of it; lr 1e-3 keeps it
    near 1.)"""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.jit import TrainStep as JTrainStep
    from paddle_tpu.optimizer import Momentum as JMomentum
    jm = _jax_model("resnet18", num_classes=10)
    weights = _arrays(jm)
    x = _rand((2, 3, 64, 64), 1)
    y = np.array([3, 7], np.int64)
    jstep = JTrainStep(jm, lambda m, a, b: JF.cross_entropy(m(a), b),
                       JMomentum(learning_rate=1e-3, momentum=0.9,
                                 parameters=jm.parameters(),
                                 weight_decay=1e-4))
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
          for _ in range(2)]
    jstep.sync_to_layer()
    want = _arrays(jm)
    for channels_last in (True, False):
        tm = TM.resnet18(num_classes=10, device="cpu")
        load_jax_weights(tm, weights)
        with flag_scope("jit_channels_last", channels_last):
            step = TrainStep(tm, _ce, Momentum(
                learning_rate=1e-3, momentum=0.9,
                parameters=tm.parameters(), weight_decay=1e-4))
            tl = [float(step(x, y)) for _ in range(2)]
        assert tm.conv1.weight.is_contiguous(
            memory_format=torch.channels_last) == channels_last
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        got = tm.state_dict()
        for k, v in want.items():
            assert _max_rel(got[k].numpy(), v, PARAM_FLOOR) < PARAM_TOL, k
        assert not np.allclose(got["bn1._variance"].numpy(), 1.0)


def test_resnet50_forward_backward_matches_jax():
    """Loss, per-tensor gradients and BN statistics at [2, 3, 64, 64].
    With every bottleneck's last BN at gamma 1 the randomly drawn network
    grows its gradients about 10x a stage backwards, and float32 rounding
    with them: both packages' gradients then sit percents from a float64
    evaluation, whatever the batch or image size. Both models take the
    same weights with that gamma at ``R50_BRANCH_GAMMA`` (as a
    zero-initialised residual branch starts near 0), where the gradients
    keep their scale through the 16 blocks and float32 is well
    conditioned, so the per-tensor limit sees a wrong axis, layout or
    backward in any one of the 161 tensors."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    jm = _jax_model("resnet50", num_classes=10)
    weights = _arrays(jm)
    for k in weights:
        if k.endswith("bn3.weight"):
            weights[k] = weights[k] * np.float32(R50_BRANCH_GAMMA)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    tm = TM.resnet50(num_classes=10, device="cpu")
    load_jax_weights(tm, weights)
    x = _rand((2, 3, 64, 64), 2)
    y = np.array([1, 8], np.int64)
    jl = JF.cross_entropy(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    jl.backward()
    tl = TF.cross_entropy(tm(torch.tensor(x)), torch.tensor(y))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    jg = {k: np.asarray(p.grad._data, np.float64)
          for k, p in jm.named_parameters()}
    tg = {k: p.grad.double().numpy() for k, p in tm.named_parameters()}
    assert tg.keys() == jg.keys() and len(jg) == 161
    for k in jg:
        rel = np.linalg.norm(tg[k] - jg[k]) / (np.linalg.norm(jg[k]) + 1e-12)
        assert rel < R50_GRAD_L2_TOL, f"{k}: grad L2-relative error {rel:.2e}"
    jb = _arrays(jm)
    for k, v in tm.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            assert _max_rel(v.numpy(), jb[k]) < PARAM_TOL, k


@pytest.mark.parametrize("name,kw", [
    ("vgg11", dict(num_classes=0, batch_norm=True)),
    ("mobilenet_v2", dict(num_classes=7, scale=0.25)),
])
def test_eval_forward_matches_jax(name, kw):
    """The evaluation forward (BN on running statistics, drawn at random
    into both models) of VGG-11 (with BN) and MobileNetV2 at scale
    0.25; the port's ``data_format="NHWC"`` model (channels-last inside,
    NCHW on both ends) gives the same logits."""
    import paddle_tpu as paddle
    jm = _jax_model(name, **kw)
    weights = _arrays(jm)
    for i, k in enumerate(sorted(weights)):
        if k.endswith("_mean"):
            weights[k] = _rand(weights[k].shape, i) * 0.1
        elif k.endswith("_variance"):
            weights[k] = np.abs(_rand(weights[k].shape, i)) + 0.5
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    jm.eval()
    x = _rand((2, 3, 32, 32), 3)
    want = np.asarray(jm(paddle.to_tensor(x))._data)
    for fmt in ("NCHW", "NHWC"):
        tm = getattr(TM, name)(device="cpu", data_format=fmt, **kw)
        load_jax_weights(tm, weights)
        tm.eval()
        with torch.no_grad():
            got = tm(torch.tensor(x))
        assert tuple(got.shape) == want.shape
        assert _max_rel(got.numpy(), want) < PARAM_TOL, fmt


def test_fold_conv_bn_counts_20_on_resnet18_and_keeps_the_output():
    from paddle_tpu.inference.passes import fold_conv_bn as jfold
    from paddle_tpu_torch.inference.passes import fold_conv_bn
    jm, tm = _pair("resnet18", num_classes=10)
    x = _rand((2, 3, 32, 32), 4)
    tm(torch.tensor(x))                  # a train-mode pass moves the stats
    tm.eval()
    with torch.no_grad():
        before = tm(torch.tensor(x)).numpy()
        assert fold_conv_bn(tm) == 20
        after = tm(torch.tensor(x)).numpy()
    assert not any(k.endswith("_mean") for k in tm.state_dict())
    assert _max_rel(after, before) < 1e-5
    jm.eval()
    assert jfold(jm) == 20


def _small_bn_model():
    from paddle_tpu_torch import nn
    m = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                      nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                      nn.Linear(8, 10))
    for layer in m.modules():
        if hasattr(layer, "reset_parameters") and layer is not m:
            layer.reset_parameters(torch.Generator().manual_seed(0))
    return m


def test_nonfinite_skip_puts_bn_buffers_back():
    """A NaN batch makes the batch statistics (and the loss) NaN: within
    the budget the step is skipped, and the running statistics the
    forward wrote are put back with the parameters untouched."""
    tm = _small_bn_model()
    step = TrainStep(tm, _ce, Momentum(0.01, parameters=tm.parameters()),
                     skip_nonfinite_budget=1)
    x = _rand((2, 3, 16, 16), 5)
    y = np.array([0, 1], np.int64)
    step(x, y)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    with pytest.warns(RuntimeWarning, match="rolled back"):
        step(bad, y)
    assert step.step_count == 1
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert np.isfinite(float(step(x, y)))


def test_models_refuse_the_cpu_default_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.LeNet()


# -- the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resnet18_trainstep_on_card_matches_cpu(cuda):
    """Two float32 steps on the card beside the CPU from the same weights
    (convs f32 whatever the TF32 flag), channels-last on both: losses
    within 1e-4 relative, parameters and BN buffers within 1e-4 of their
    largest magnitude (differences under ``PARAM_FLOOR`` absolute count
    as none: cuDNN's and the CPU's sums differ in order)."""
    x = _rand((4, 3, 64, 64), 6)
    y = np.array([0, 3, 5, 9], np.int64)
    weights = TM.resnet18(num_classes=10, device="cpu", seed=3).state_dict()
    out = []
    for dev in ("cpu", cuda):
        m = TM.resnet18(num_classes=10, device=dev)
        m.load_state_dict(weights)
        step = TrainStep(m, _ce, Momentum(1e-3, parameters=m.parameters()))
        out.append(([float(step(x, y)) for _ in range(2)],
                    {k: v.cpu() for k, v in m.state_dict().items()}))
    (lc, sc), (lg, sg) = out
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for k, v in sc.items():
        err = _max_rel(sg[k].numpy(), v.numpy(), PARAM_FLOOR)
        assert err < 1e-4, f"{k}: {err:.3e}"
