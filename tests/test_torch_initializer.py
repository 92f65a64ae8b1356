"""``paddle_tpu_torch.nn.initializer`` against the JAX package on the CPU.

The deterministic initializers (``Constant``, ``Assign``, ``Dirac``) and
``calculate_gain`` equal the JAX ones exactly. The random ones draw from
another generator than JAX's, so they are held to their distribution:
every draw inside its bounds (``Uniform`` and the Xavier / Kaiming
uniforms within the JAX limit, ``TruncatedNormal`` within two standard
deviations), the sample mean within ``MEAN_TOL`` standard errors of the
JAX parameter and the sample standard deviation within ``STD_RTOL`` of
the JAX formula's, on 65536 draws; ``Orthogonal`` orthogonal to 1e-5.
``ParamAttr`` objects on ``Linear``, ``Embedding``, ``Conv2D`` and
``BatchNorm2D`` give the parameters the JAX layer's values, freeze the
``trainable=False`` ones and carry ``learning_rate``.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as TI

SHAPE = (256, 16, 4, 4)            # 65536 draws; fans 256 and 4096
MEAN_TOL = 5.0                     # standard errors
STD_RTOL = 0.02


def test_calculate_gain_equals_jax():
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu"):
        assert TI.calculate_gain(nl) == JI.calculate_gain(nl)
    assert TI.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)


@pytest.mark.parametrize("name,args", [
    ("Constant", (0.37,)),
    ("Assign", (np.arange(24, dtype=np.float32).reshape(4, 6),)),
    ("Dirac", (1,)),
    ("Dirac", (2,)),
])
def test_deterministic_initializers_equal_jax(name, args):
    shape = (4, 6) if name == "Assign" else (4, 2, 3, 3) if name == "Dirac" \
        else (3, 5)
    want = np.asarray(getattr(JI, name)(*args)(shape, "float32"))
    got = getattr(TI, name)(*args)(shape, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Assign shape"):
        TI.Assign(np.zeros(3))((4,))


def _fans():
    fan_in = SHAPE[1] * SHAPE[2] * SHAPE[3]
    fan_out = SHAPE[0] * SHAPE[2] * SHAPE[3]
    return fan_in, fan_out


@pytest.mark.parametrize("name,kw,mean,std,limit", [
    ("Normal", dict(mean=0.5, std=2.0), 0.5, 2.0, None),
    ("TruncatedNormal", dict(mean=-1.0, std=0.5), -1.0, None, 1.0),
    ("Uniform", dict(low=-0.3, high=0.7), 0.2, 1.0 / math.sqrt(12), 0.5),
    ("XavierNormal", dict(gain=1.5), 0.0, "xavier_n", None),
    ("XavierUniform", dict(), 0.0, "xavier_u", "xavier_u"),
    ("KaimingNormal", dict(), 0.0, "kaiming_n", None),
    ("KaimingUniform", dict(negative_slope=0.1,
                            nonlinearity="leaky_relu"), 0.0, "kaiming_u",
     "kaiming_u"),
])
def test_random_initializers_follow_the_jax_distribution(name, kw, mean,
                                                         std, limit):
    fi, fo = _fans()
    xavier_u = math.sqrt(6.0 / (fi + fo))
    kaiming_u = JI.calculate_gain("leaky_relu", 0.1) * math.sqrt(3.0 / fi)
    stds = {"xavier_n": 1.5 * math.sqrt(2.0 / (fi + fo)),
            "xavier_u": xavier_u / math.sqrt(3),
            "kaiming_n": math.sqrt(2.0) / math.sqrt(fi),
            "kaiming_u": kaiming_u / math.sqrt(3)}
    limits = {"xavier_u": xavier_u, "kaiming_u": kaiming_u}
    if name == "TruncatedNormal":
        # a N(0, 1) cut at +-2 has a standard deviation of 0.8796
        std = 0.5 * 0.879596
    std = stds.get(std, std)
    limit = limits.get(limit, limit)
    g = torch.Generator().manual_seed(7)
    got = getattr(TI, name)(**kw)(SHAPE, torch.float32, generator=g) \
        .numpy().astype(np.float64)
    ref = np.asarray(getattr(JI, name)(**kw)(SHAPE, "float32"), np.float64)
    for v in (got, ref):
        assert abs(v.mean() - mean) < MEAN_TOL * std / math.sqrt(v.size)
        assert abs(v.std() / std - 1.0) < STD_RTOL
        if limit is not None:
            assert np.abs(v - mean).max() <= limit * (1 + 1e-6)
    again = getattr(TI, name)(**kw)(SHAPE, generator=torch.Generator()
                                    .manual_seed(7)).numpy()
    np.testing.assert_array_equal(again, got.astype(np.float32))


def test_orthogonal_is_orthogonal():
    for shape in ((6, 10), (10, 6)):
        w = TI.Orthogonal(gain=2.0)(shape).numpy().astype(np.float64)
        jw = np.asarray(JI.Orthogonal(gain=2.0)(shape, "float32"),
                        np.float64)
        for m in (w, jw):
            small = m @ m.T if shape[0] <= shape[1] else m.T @ m
            np.testing.assert_allclose(small, 4.0 * np.eye(min(shape)),
                                       atol=1e-5)


def _jarr(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def test_param_attr_on_linear_embedding_conv_and_bn_equals_jax():
    c = np.random.default_rng(0).normal(size=(6, 3, 3, 3)).astype(
        np.float32)
    cases = [
        (lambda m: m.Linear(4, 5, weight_attr=m_init(m).Constant(0.25),
                            bias_attr=m_attr(m)(initializer=m_init(m)
                                                .Constant(-1.0),
                                                learning_rate=0.5))),
        (lambda m: m.Embedding(7, 3, weight_attr=m_init(m).Constant(2.0))),
        (lambda m: m.Conv2D(3, 6, 3, weight_attr=m_attr(m)(
            initializer=m_init(m).Assign(c), trainable=False),
            bias_attr=False)),
        (lambda m: m.Conv2D(2, 4, 3, weight_attr=m_init(m).Dirac(2),
                            groups=1)),
        (lambda m: m.BatchNorm2D(5, weight_attr=m_init(m).Constant(0.25),
                                 bias_attr=m_init(m).Constant(0.5))),
    ]
    for build in cases:
        paddle.seed(0)
        jl = build(jnn)
        tl = build(_TNN)
        want = _jarr(jl)
        got = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k == "bias" and isinstance(jl, jnn.Conv2D):
                continue                    # a default draw: RNGs differ
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    lin = _TNN.Linear(4, 5, bias_attr=TI.ParamAttr(learning_rate=0.5,
                                                    trainable=False))
    assert lin.bias.optimize_attr == {"learning_rate": 0.5}
    assert not lin.bias.requires_grad and lin.weight.requires_grad
    frozen = _TNN.Conv2D(3, 6, 3, weight_attr=TI.ParamAttr(
        initializer=TI.Assign(c), trainable=False))
    frozen.reset_parameters(torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(frozen.weight.detach().numpy(), c)
    out = frozen(torch.ones(1, 3, 5, 5)).sum()
    out.backward()
    assert frozen.weight.grad is None and frozen.bias.grad is not None


def test_random_attr_draws_from_the_layers_generator():
    """A random initializer in an attr takes ``reset_parameters``'s
    generator: two layers reset from equal generators are equal, and the
    draw follows the initializer (Normal(0, 0.01) here), not the layer's
    default."""
    a = _TNN.Linear(64, 32, weight_attr=TI.Normal(0.0, 0.01))
    b = _TNN.Linear(64, 32, weight_attr=TI.Normal(0.0, 0.01))
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight)
    assert abs(float(a.weight.detach().std()) - 0.01) < 0.001
    assert torch.equal(a.bias, torch.zeros(32))


class _TNNNamespace:
    """The port's layer classes with ``device="cpu"`` bound."""

    def __getattr__(self, name):
        cls = getattr(tnn, name)
        return lambda *a, **k: cls(*a, device="cpu", **k)


_TNN = _TNNNamespace()


def m_init(m):
    return JI if m is jnn else TI


def m_attr(m):
    from paddle_tpu.nn.initializer import ParamAttr as JP
    return JP if m is jnn else TI.ParamAttr
