"""``nn.Layer`` of the port against the JAX package's: the containers,
``state_dict`` / ``set_state_dict`` with numpy from the JAX model,
hooks, parameter creation and the Paddle names, a user-written layer
over facades, and every port layer class a ``Layer``. Outputs within
rtol 1e-5 / atol 1e-6."""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pp
import paddle_tpu_torch.nn as pnn
from _torch_eager_cases import port_on_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_mlp():
    jp.seed(0)
    return jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))


def _port_mlp():
    return pnn.Sequential(pnn.Linear(4, 8), pnn.ReLU(), pnn.Linear(8, 2))


def _state(jm):
    return {k: v.numpy() for k, v in jm.state_dict().items()}


def test_set_state_dict_from_jax_numpy_gives_the_jax_outputs():
    jm, pm = _jax_mlp(), _port_mlp()
    missing, unexpected = pm.set_state_dict(_state(jm))
    assert missing == [] and unexpected == []
    assert list(pm.state_dict()) == list(jm.state_dict())
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    out = pm(pp.to_tensor(x))
    assert isinstance(out, pp.Tensor) and out.shape == [3, 2]
    np.testing.assert_allclose(out.numpy(), jm(jp.to_tensor(x)).numpy(),
                               **TOL)
    # a facade value and a torch tensor load too; a wrong shape raises
    pm.set_state_dict({"0.bias": pp.to_tensor(np.ones(8, np.float32))})
    pm.set_state_dict({"2.bias": torch.ones(2)})
    np.testing.assert_array_equal(pm[0].bias.numpy(), np.ones(8))
    with pytest.raises(ValueError):
        pm.set_state_dict({"0.bias": np.ones(3, np.float32)})
    assert pm.set_state_dict({"nope": np.ones(1)})[1] == ["nope"]


def test_containers_match_jax():
    for nn in (jnn, pnn):
        seq = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
        assert len(seq) == 3 and isinstance(seq[0], nn.Linear)
        assert len(seq[1:]) == 2
        ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
        ll.append(nn.Linear(2, 3))
        assert len(ll) == 4 and len(list(ll)) == 4
        assert ll[-1] is list(ll)[3]
        ld = nn.LayerDict({"a": nn.Linear(2, 2)})
        ld["b"] = nn.ReLU()
        assert list(ld.keys()) == ["a", "b"] and "b" in ld
        assert len(ld.parameters()) == 2
    p = pp.Parameter(np.ones(3, np.float32))
    plist = pnn.ParameterList([p])
    plist.append(pp.Parameter(np.zeros(2, np.float32)))
    assert len(plist) == 2 and plist[0] is p
    assert [n for n, _ in plist.named_parameters()] == ["0", "1"]


def test_parameters_are_a_list_of_paddle_parameters():
    jm, pm = _jax_mlp(), _port_mlp()
    pm.set_state_dict(_state(jm))
    jps, pps = jm.parameters(), pm.parameters()
    assert isinstance(pps, list) and len(pps) == len(jps) == 4
    for j, p in zip(jps, pps):
        assert isinstance(p, pp.Parameter) and isinstance(p, pp.Tensor)
        assert isinstance(p, torch.nn.Parameter)
        assert p.stop_gradient == j.stop_gradient is False
        assert p.trainable
        np.testing.assert_array_equal(p.numpy(), j.numpy())
        assert p.gradient() is None
    # torch's keyword still gives torch's generator
    assert inspect.isgenerator(pm.parameters(recurse=True))
    assert len(list(pm.parameters(include_sublayers=False))) == 0
    pps[0].stop_gradient = True
    assert not pps[0].requires_grad
    pps[0].name = "w0"
    assert pps[0].name == "w0"


def test_gradients_and_clear_gradients():
    jm, pm = _jax_mlp(), _port_mlp()
    pm.set_state_dict(_state(jm))
    x = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    jm(jp.to_tensor(x)).sum().backward()
    pm(pp.to_tensor(x)).sum().backward()
    for j, p in zip(jm.parameters(), pm.parameters()):
        np.testing.assert_allclose(p.gradient(), j.grad.numpy(), **TOL)
        np.testing.assert_allclose(p.grad.numpy(), j.grad.numpy(), **TOL)
    pm.clear_gradients()
    jm.clear_gradients()
    assert all(p.grad is None for p in pm.parameters())


def test_forward_hooks():
    for nn, pkg in ((jnn, jp), (pnn, pp)):
        lin = nn.Linear(2, 2)
        calls = []
        pre = lin.register_forward_pre_hook(
            lambda layer, inp: calls.append("pre"))
        post = lin.register_forward_post_hook(
            lambda layer, inp, out: calls.append("post"))
        x = pkg.to_tensor(np.ones((1, 2), np.float32))
        lin(x)
        pre.remove()
        post.remove()
        lin(x)
        assert calls == ["pre", "post"]


def test_a_post_hook_may_replace_the_output():
    for nn, pkg in ((jnn, jp), (pnn, pp)):
        lin = nn.Linear(2, 2)
        lin.register_forward_post_hook(lambda layer, inp, out: out * 0)
        out = lin(pkg.to_tensor(np.ones((1, 2), np.float32)))
        np.testing.assert_array_equal(out.numpy(), np.zeros((1, 2)))


class _UserNet(pnn.Layer):
    """Paddle code: its forward gets and returns facades."""

    def __init__(self):
        super().__init__()
        self.fc = pnn.Linear(4, 3)
        self.w = self.create_parameter([3, 2])
        self.b = self.create_parameter([2], is_bias=True)
        self.register_buffer("steps", pp.to_tensor(np.zeros(1, np.float32)),
                             persistable=False)
        self.seen = []

    def forward(self, x):
        self.seen.append(type(x))
        h = pp.tanh(self.fc(x))
        return pp.matmul(h, self.w) + self.b


def test_a_user_layer_runs_paddle_code_on_facades():
    net = _UserNet()
    assert set(net.state_dict()) == {"fc.weight", "fc.bias", "w", "b"}
    assert isinstance(net.w, pp.Parameter) and not net.w.stop_gradient
    np.testing.assert_array_equal(net.b.numpy(), np.zeros(2))
    x = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    out = net(pp.to_tensor(x))
    assert isinstance(out, pp.Tensor) and out.shape == [5, 2]
    # given a torch tensor (as TrainStep gives it), the forward still
    # sees a facade and the caller gets a torch tensor back
    plain = net(torch.from_numpy(x))
    assert type(plain) is torch.Tensor
    assert net.seen == [pp.Tensor, pp.Tensor]
    np.testing.assert_array_equal(plain.detach().numpy(), out.numpy())
    # weights from the JAX twin give the JAX outputs
    jp.seed(0)

    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(4, 3)
            self.w = self.create_parameter([3, 2])
            self.b = self.create_parameter([2], is_bias=True)

        def forward(self, a):
            return jp.matmul(jp.tanh(self.fc(a)), self.w) + self.b

    jn = JNet()
    net.set_state_dict(_state(jn))
    np.testing.assert_allclose(net(pp.to_tensor(x)).numpy(),
                               jn(jp.to_tensor(x)).numpy(), **TOL)


def test_layer_paddle_names():
    net = _port_mlp()
    assert net.full_name() == "sequential"
    assert [n for n, _ in net.named_sublayers()] == ["0", "1", "2"]
    assert len(net.sublayers()) == 3
    assert net.sublayers(include_self=True)[0] is net
    extra = net.add_sublayer("extra", pnn.ReLU())
    assert net.extra is extra
    p = net.add_parameter("scale", pp.Parameter(np.ones(1, np.float32)))
    assert net.scale is p and "scale" in net.state_dict()
    net.astype("bfloat16")
    assert net[0].weight.dtype == pp.bfloat16
    net.eval()
    assert not net[0].training
    net.train()
    assert net[0].training


def test_create_parameter_draws_from_paddle_seed():
    layer = pnn.Layer()
    pp.seed(5)
    a = layer.create_parameter([3, 4]).numpy()
    pp.seed(5)
    b = layer.create_parameter([3, 4]).numpy()
    np.testing.assert_array_equal(a, b)
    limit = np.sqrt(6.0 / 7.0)
    assert np.abs(a).max() <= limit and a.std() > 0
    assert layer.create_parameter([2], attr=False) is None
    frozen = layer.create_parameter(
        [2], attr=pnn.initializer.ParamAttr(trainable=False))
    assert frozen.stop_gradient


def _port_layer_classes():
    import paddle_tpu_torch
    out = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        mod = importlib.import_module(info.name)
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ == info.name and issubclass(
                    cls, torch.nn.Module):
                out.append(cls)
    return out


def test_every_port_layer_class_is_a_layer():
    classes = _port_layer_classes()
    assert len(classes) > 60
    assert [c.__qualname__ for c in classes
            if not issubclass(c, pnn.Layer)] == []
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    model = GPTForPretraining(gpt_tiny(), device="cpu")
    assert isinstance(model, pnn.Layer)
    assert all(isinstance(p, pp.Parameter) for p in model.parameters())
