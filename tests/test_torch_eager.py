"""The eager (dygraph) slice as a whole: ``import paddle_tpu_torch as
paddle`` runs the JAX package's training loops and keeps the facade out
of the port's modules.

- LeNet trained eagerly as ``tests/test_e2e_models.py:15`` trains it,
  step by step against the JAX loop from the same weights and batches
  (losses within rtol 1e-4: twelve Adam steps of f32 convolutions);
- ``gpt_tiny`` trained two steps by the dygraph loop in both packages,
  weights carried by ``models/convert.py`` (f32, dropout 0): losses and
  parameters within 1e-5, and no facade inside the port's GPT;
- the eager loop after ``paddle.seed(s)`` against ``TrainStep(seed=s)``
  from the same weights, dropout on, f32 and O1: bit-equal;
- ``F.scaled_dot_product_attention`` on facades against the direct
  ``ops.attention`` call (bit-equal) and the JAX op (within 1e-5);
- the namespace against the JAX package's and the default device.

The JAX package is imported inside the tests that use it: the
``cuda``-marked cases run on a machine without JAX.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pp
from _torch_eager_cases import port_on_cpu  # noqa: F401
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.core import device as pdevice
from paddle_tpu_torch.core.tensor import has_facade
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.ops import attention as pattention
from paddle_tpu_torch.ops import kernels


def _jax_named(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _gpt_batch(vocab, B=2, S=16, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, vocab, (B, S)).astype(np.int32),
            r.integers(0, vocab, (B, S)).astype(np.int32))


def test_lenet_eager_loop_matches_jax():
    import paddle_tpu as jp
    from paddle_tpu.vision.models import LeNet as JaxLeNet
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    jp.seed(0)
    jnet = JaxLeNet()
    net = LeNet(device="cpu")
    net.set_state_dict(_jax_named(jnet))
    jopt = jp.optimizer.Adam(learning_rate=5e-3, parameters=jnet.parameters())
    opt = pp.optimizer.Adam(learning_rate=5e-3, parameters=net.parameters())
    jloss_fn, loss_fn = jp.nn.CrossEntropyLoss(), pp.nn.CrossEntropyLoss()
    loader = DataLoader(MNIST(mode="train", num_synthetic=96), batch_size=32,
                        drop_last=True)
    losses, jlosses = [], []
    for _ in range(4):
        for x, y in loader:
            xn, yn = x.numpy(), y.numpy().reshape(-1).astype(np.int64)
            out = net(pp.to_tensor(xn))
            assert isinstance(out, pp.Tensor)
            loss = loss_fn(out, pp.to_tensor(yn))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            jl = jloss_fn(jnet(jp.to_tensor(xn)), jp.to_tensor(yn))
            jl.backward()
            jopt.step()
            jopt.clear_grad()
            jlosses.append(float(jl))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_one_eager_step_equals_one_trainstep_step():
    """``tests/test_e2e_models.py::test_eager_and_jit_agree`` in the
    port: the same init and data, one eager SGD step against one
    ``TrainStep`` step that is given facade tensors."""
    import paddle_tpu as jp
    jp.seed(7)
    jnet = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.Tanh(),
                            jp.nn.Linear(16, 4))

    def build():
        net = pp.nn.Sequential(pp.nn.Linear(8, 16), pp.nn.Tanh(),
                               pp.nn.Linear(16, 4))
        net.set_state_dict(_jax_named(jnet))
        return net, pp.optimizer.SGD(learning_rate=0.1,
                                     parameters=net.parameters())

    r = np.random.default_rng(0)
    x = pp.to_tensor(r.standard_normal((4, 8)).astype(np.float32))
    y = pp.to_tensor(r.integers(0, 4, 4), dtype="int64")
    loss_layer = pp.nn.CrossEntropyLoss()
    net1, opt1 = build()
    l1 = loss_layer(net1(x), y)
    l1.backward()
    opt1.step()
    net2, opt2 = build()
    step = TrainStep(net2, lambda m, a, b: loss_layer(m(a), b), opt2)
    l2 = step(x, y)
    assert float(l1) == float(l2)
    for p1, p2 in zip(net1.parameters(), net2.parameters()):
        np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def test_entry_points_take_facades(tmp_path):
    """The optimizer (a facade leaf), ``hapi.Model``, ``save`` / ``load``
    and ``load_jax_weights`` take facades as they take torch tensors."""
    w = pp.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    opt = pp.optimizer.SGD(learning_rate=0.5, parameters=[w])
    (w * w).sum().backward()
    opt.step()
    np.testing.assert_array_equal(w.numpy(), [0.0, 0.0, 0.0])
    net = pp.nn.Sequential(pp.nn.Linear(4, 2))
    pp.save({"w": w, "nested": [pp.to_tensor([1.0, 2.0])]},
            str(tmp_path / "a.pdparams"))
    back = pp.load(str(tmp_path / "a.pdparams"))
    np.testing.assert_array_equal(back["nested"][0], [1.0, 2.0])
    load_jax_weights(net, {k: pp.to_tensor(np.full(v.shape, 0.5, np.float32))
                           for k, v in net.state_dict().items()})
    np.testing.assert_array_equal(net[0].weight.numpy(), np.full((4, 2), 0.5))
    model = pp.Model(net)
    model.prepare(pp.optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()),
                  pp.nn.CrossEntropyLoss())
    x = pp.to_tensor(np.ones((3, 4), np.float32))
    y = pp.to_tensor(np.array([0, 1, 0]))
    assert np.isfinite(model.train_batch([x], [y])[0])
    assert model.predict_batch([x])[0].shape == (3, 2)


def _no_facade_inside(model):
    """Hooks on every submodule of ``model`` that record any facade among
    a call's inputs or outputs."""
    seen = []

    def pre(m, args, kwargs):
        if has_facade(args) or has_facade(kwargs):
            seen.append(type(m).__name__)

    def post(m, args, out):
        if has_facade(out):
            seen.append(type(m).__name__)
    hooks = [h for m in model.modules() for h in (
        m.register_forward_pre_hook(pre, with_kwargs=True),
        m.register_forward_hook(post))]
    return seen, hooks


def test_gpt_tiny_dygraph_loop_matches_jax_and_keeps_facades_out():
    import paddle_tpu as jp
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    jp.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    pm = load_jax_weights(GPTForPretraining(gpt_tiny(), device="cpu"),
                          _jax_named(jm))
    jcrit, crit = JaxCrit(), GPTPretrainingCriterion()
    jopt = jp.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                              weight_decay=0.01)
    opt = pp.optimizer.AdamW(learning_rate=1e-3, parameters=pm.parameters(),
                             weight_decay=0.01)
    ids, labels = _gpt_batch(gpt_tiny().vocab_size)
    seen, hooks = _no_facade_inside(pm)
    losses, jlosses = [], []
    for _ in range(2):
        logits = pm(pp.to_tensor(ids))
        assert isinstance(logits, pp.Tensor)
        loss = crit(logits, pp.to_tensor(labels))
        assert isinstance(loss, pp.Tensor)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        jl = jcrit(jm(jp.to_tensor(ids)), jp.to_tensor(labels))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(jl))
    for h in hooks:
        h.remove()
    assert seen == []
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    jsd = _jax_named(jm)
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jsd[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "O1"])
def test_eager_loop_after_seed_is_bit_equal_to_trainstep(amp):
    """``paddle.seed(0)`` and ``TrainStep(seed=0)`` draw the same dropout
    seed words, so the loop ``backward; step; clear_grad`` is the
    step's own, bit for bit (the flash and chunked-CE paths: vocab above
    4096, head dim 64)."""
    cfg = gpt_tiny(vocab_size=4352, hidden_size=128, num_heads=2,
                   num_layers=1, hidden_dropout_prob=0.1,
                   attention_dropout_prob=0.1)
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        with auto_cast(enable=amp, level="O1"):
            return crit(layer(ids), labels)

    def opt(m):
        return pp.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=m.parameters(),
                                  weight_decay=0.01)

    ids, labels = _gpt_batch(cfg.vocab_size)
    m1 = GPTForPretraining(cfg, device="cpu", seed=0)
    step = TrainStep(m1, loss_fn, opt(m1), seed=0)
    want = [float(step(ids, labels)) for _ in range(2)]
    m2 = GPTForPretraining(cfg, device="cpu", seed=0)
    o2 = opt(m2)
    pp.seed(0)
    got = []
    for _ in range(2):
        loss = loss_fn(m2, pp.to_tensor(ids), pp.to_tensor(labels))
        loss.backward()
        o2.step()
        o2.clear_grad()
        got.append(float(loss))
    assert got == want
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k


def _attention_inputs(B, S, H, D, seed, mask):
    r = np.random.default_rng(seed)
    qkv = [r.standard_normal((B, S, H, D)).astype(np.float32)
           for _ in range(3)]
    if not mask:
        return qkv, None
    m = np.zeros((B, 1, 1, S), np.float32)
    m[1, ..., S // 2:] = -1e30
    return qkv, m


@pytest.mark.parametrize("mask", [False, True], ids=["causal", "key_bias"])
def test_public_sdpa_on_facades_is_the_direct_call(mask):
    """The public op on facades, with dropout under ``paddle.seed`` and
    gradients from ``paddle.grad``, gives the bits of
    ``ops.attention.scaled_dot_product_attention`` on torch tensors."""
    (q, k, v), m = _attention_inputs(2, 64, 2, 64, 3, mask)
    kw = dict(dropout_p=0.1, is_causal=not mask)
    pp.seed(11)
    fq, fk, fv = (pp.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    fm = None if m is None else pp.to_tensor(m)
    out = pp.nn.functional.scaled_dot_product_attention(fq, fk, fv, fm, **kw)
    assert isinstance(out, pp.Tensor)
    grads = pp.grad((out * out).sum(), [fq, fk, fv])
    pp.seed(11)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tm = None if m is None else torch.tensor(m)
    ref = pattention.scaled_dot_product_attention(tq, tk, tv, tm, **kw)
    refg = torch.autograd.grad((ref * ref).sum(), [tq, tk, tv])
    assert torch.equal(out._data, ref)
    for g, r in zip(grads, refg):
        assert torch.equal(g._data, r)


@pytest.mark.parametrize("mask", [False, True], ids=["causal", "key_bias"])
def test_public_sdpa_matches_jax(mask):
    import paddle_tpu as jp
    (q, k, v), m = _attention_inputs(2, 64, 2, 64, 4, mask)
    outs = []
    for pkg in (jp, pp):
        t = [pkg.to_tensor(a) for a in (q, k, v)]
        tm = None if m is None else pkg.to_tensor(m)
        outs.append(pkg.nn.functional.scaled_dot_product_attention(
            *t, tm, is_causal=not mask).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


# the JAX top-level names the port has no module for yet (ROADMAP Queue
# 1): tensor/sequence.py, tensor/tail.py, and ``apply`` (not ported by
# decision: torch's autograd is the tape)
STILL_MISSING = {
    "addmm", "batch", "broadcast_tensors", "check_shape", "clip_by_norm",
    "conj", "create_parameter", "diag_embed", "diagonal",
    "disable_signal_handler", "edit_distance", "fill_diagonal_",
    "flatten_", "floor_mod", "flops", "rank", "reshape_", "reverse",
    "scatter_", "set_printoptions", "shape", "squeeze_", "tanh_",
    "unsqueeze_", "sequence_concat", "sequence_enumerate",
    "sequence_expand_as", "sequence_pad", "sequence_pool",
    "sequence_reverse", "sequence_softmax", "sequence_unpad", "apply",
}
# the JAX package's subpackages (``from . import x`` in its
# ``__init__.py``) the port has no counterpart of yet (ROADMAP Queue 1)
STILL_MISSING_MODULES = {
    "compat", "distribution", "fft", "hub", "onnx", "reader",
    "regularizer", "signal", "static", "sysconfig", "text", "utils",
    "version",
}


def test_namespace_against_the_jax_package(capsys):
    """Every JAX top-level name that is not a module is in the port's
    namespace or in ``STILL_MISSING``, every subpackage the JAX
    ``__init__.py`` imports is the port's or in
    ``STILL_MISSING_MODULES`` (ROADMAP Queue 1); the modules of this
    slice have all of their public names."""
    import inspect
    import re
    import types
    import paddle_tpu as jp
    import __future__
    names = {n for n in dir(jp) if not n.startswith("_")
             and not isinstance(getattr(jp, n), (types.ModuleType,
                                                 __future__._Feature))}
    missing = sorted(n for n in names if not hasattr(pp, n))
    subpackages = set(re.findall(r"^from \. import (\w+)",
                                 inspect.getsource(jp), re.M))
    missing_modules = sorted(m for m in subpackages if not hasattr(pp, m))
    with capsys.disabled():
        print(f"\nJAX top-level names not in the port: {missing}\n"
              f"JAX subpackages not in the port: {missing_modules}")
    assert set(missing) <= STILL_MISSING
    assert set(missing_modules) <= STILL_MISSING_MODULES
    import paddle_tpu.autograd as jautograd
    import paddle_tpu.core.dtype as jdtype
    import paddle_tpu.device as jdevice
    import paddle_tpu.nn.layer as jlayer
    import paddle_tpu_torch.autograd as pautograd
    import paddle_tpu_torch.core.dtype as pdtype
    import paddle_tpu_torch.device as pdevice_ns
    import paddle_tpu_torch.nn.layer as player
    for jmod, pmod in ((jautograd, pautograd), (jdtype, pdtype),
                       (jdevice, pdevice_ns), (jlayer, player)):
        public = getattr(jmod, "__all__", None) or [
            n for n in dir(jmod) if not n.startswith("_")
            and getattr(getattr(jmod, n), "__module__", "").startswith(
                jmod.__name__)]
        assert [n for n in public if not hasattr(pmod, n)] == [], jmod
    assert pp.float32 is torch.float32 and pp.bool is torch.bool
    assert pp.dtype is torch.dtype


def test_default_device_is_the_card():
    """Without ``set_device`` the creation functions take the card, and
    raise where there is none unless the caller asks for the CPU."""
    pdevice._DEFAULT_DEVICE.clear()
    if torch.cuda.is_available():
        assert pp.to_tensor([1.0])._data.device.type == "cuda"
        assert pp.get_device() == "gpu:0"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pp.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA"):
            pp.zeros([2])
    assert pp.to_tensor([1.0], place="cpu").place == pp.CPUPlace()
    pp.set_device("cpu")
    assert pp.get_device() == "cpu:0" and pp.ones([2]).place == pp.CPUPlace()
    assert pp.nn.Linear(2, 3).weight.device.type == "cpu"


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    pp.set_device("gpu")
    return torch.device("cuda")


@pytest.mark.cuda
def test_to_tensor_lands_on_the_card_by_default(cuda):
    pdevice._DEFAULT_DEVICE.clear()
    assert pp.to_tensor([1.0])._data.device.type == "cuda"
    assert pp.zeros([2]).place == pp.CUDAPlace(0)
    assert pp.get_device() == "gpu:0"


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [False, True], ids=["causal", "key_bias"])
def test_public_sdpa_on_card_is_the_direct_call_and_launches_the_rows(
        cuda, mask):
    (q, k, v), m = _attention_inputs(2, 256, 4, 64, 5, mask)
    kw = dict(dropout_p=0.1, is_causal=not mask)
    fwd = kernels.FLASH_ATTENTION_BIAS_FWD if mask \
        else kernels.FLASH_ATTENTION_FWD
    before = fwd.launches
    pp.seed(2)
    fq, fk, fv = (pp.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    fm = None if m is None else pp.to_tensor(m)
    out = pp.nn.functional.scaled_dot_product_attention(fq, fk, fv, fm, **kw)
    grads = pp.grad(out.sum(), [fq, fk, fv])
    assert fwd.launches == before + 1
    pp.seed(2)
    tq, tk, tv = (torch.tensor(a, device=cuda, requires_grad=True)
                  for a in (q, k, v))
    tm = None if m is None else torch.tensor(m, device=cuda)
    ref = pattention.scaled_dot_product_attention(tq, tk, tv, tm, **kw)
    refg = torch.autograd.grad(ref.sum(), [tq, tk, tv])
    assert torch.equal(out._data, ref)
    for g, r in zip(grads, refg):
        assert torch.equal(g._data, r)


@pytest.mark.cuda
def test_eager_loop_on_card_equals_trainstep(cuda):
    cfg = gpt_tiny(vocab_size=4352, hidden_size=128, num_heads=2,
                   hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    crit = GPTPretrainingCriterion()
    ids, labels = _gpt_batch(cfg.vocab_size, S=128)

    def run(eager):
        m = GPTForPretraining(cfg, seed=0)
        opt = pp.optimizer.AdamW(1e-3, parameters=m.parameters())
        if not eager:
            step = TrainStep(m, lambda l, a, b: crit(l(a), b), opt, seed=0)
            return [float(step(ids, labels)) for _ in range(2)]
        pp.seed(0)
        out = []
        for _ in range(2):
            loss = crit(m(pp.to_tensor(ids)), pp.to_tensor(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        return out
    kernels.reset_launch_counts()
    want = run(False)
    counts = {k["name"]: k["launches"] for k in kernels.kernels()}
    kernels.reset_launch_counts()
    assert run(True) == want
    assert {k["name"]: k["launches"] for k in kernels.kernels()} == counts
