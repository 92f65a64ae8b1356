"""The port's Momentum, LR schedulers, vision datasets and transforms
against the JAX package on the CPU.

``Momentum`` (heavy ball and Nesterov, coupled L2 ``weight_decay``,
``rescale_grad``) against the JAX rule over several steps within 1e-6
relative (float32 products in the same order); all fifteen schedulers'
rates against the JAX ones, exactly (the same Python arithmetic); an
optimizer driven by a scheduler through ``state_dict`` / ``set_state_dict``
and through ``TrainStep.state_dict`` / ``set_state_dict`` (the resumed
run's loss bit-equal to the uninterrupted one); synthetic MNIST,
FashionMNIST, Cifar10/100 and Flowers samples bit-equal to the JAX
package's, MNIST's idx files and ``DatasetFolder`` read alike; every
transform, ``Resize`` within 1e-6 (``jax.image.resize``'s weights in
another summation order) and the random ones bit-equal after the same
``np.random.seed``.

The ``cuda``-marked case runs ``Momentum`` on the card against the CPU
(``python -m pytest --noconftest -m cuda tests/test_torch_vision_data.py``)
and skips here.
"""

import gzip
import math
import struct

import numpy as np
import pytest
import torch

from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.optimizer import SGD, Momentum
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tt


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- Momentum ------------------------------------------------------------------
def _jax_momentum_run(w0, b0, cots, **kw):
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.optimizer import Momentum as JMomentum
    lin = paddle.nn.Linear(*w0.shape)
    lin.weight._data = jnp.asarray(w0)
    lin.bias._data = jnp.asarray(b0)
    opt = JMomentum(parameters=lin.parameters(), **kw)
    for cw, cb in cots:
        loss = (lin.weight * paddle.to_tensor(cw)).sum() + \
            (lin.bias * paddle.to_tensor(cb)).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return lin.weight.numpy(), lin.bias.numpy()


def _torch_momentum_run(w0, b0, cots, device="cpu", **kw):
    w = torch.nn.Parameter(torch.tensor(w0, device=device))
    b = torch.nn.Parameter(torch.tensor(b0, device=device))
    opt = Momentum(parameters=[w, b], **kw)
    for cw, cb in cots:
        loss = (w * torch.tensor(cw, device=device)).sum() + \
            (b * torch.tensor(cb, device=device)).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return w.detach().cpu().numpy(), b.detach().cpu().numpy()


MOMENTUM_CASES = [dict(learning_rate=0.1),
                  dict(learning_rate=0.05, momentum=0.8, use_nesterov=True),
                  dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-2),
                  dict(learning_rate=0.02, use_nesterov=True,
                       weight_decay=1e-4, rescale_grad=0.5)]


@pytest.mark.parametrize("case", range(len(MOMENTUM_CASES)))
def test_momentum_matches_jax(case):
    kw = MOMENTUM_CASES[case]
    w0, b0 = _rand((4, 3), 1), _rand((3,), 2)
    cots = [(_rand((4, 3), 10 + i), _rand((3,), 20 + i)) for i in range(4)]
    jw, jb = _jax_momentum_run(w0, b0, cots, **kw)
    tw, tb = _torch_momentum_run(w0, b0, cots, **kw)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-7)


# -- schedulers ----------------------------------------------------------------
def _schedulers(mod):
    """Each of the fifteen with arguments that exercise its branches."""
    return {
        "NoamDecay": lambda: mod.NoamDecay(64, 4, learning_rate=2.0),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay([3, 6],
                                                     [0.1, 0.05, 0.01]),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.1, 0.3),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.1, 0.5),
        "PolynomialDecay": lambda: mod.PolynomialDecay(0.1, 5, 0.001, 2.0),
        "PolynomialDecay_cycle": lambda: mod.PolynomialDecay(
            0.1, 4, 0.001, 1.0, cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.1, 6), 4, 0.0, 0.1),
        "LinearWarmup_float": lambda: mod.LinearWarmup(0.1, 3, 0.01, 0.1),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.1, 0.9),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.1, [2, 5, 9], 0.5),
        "StepDecay": lambda: mod.StepDecay(0.1, 3, 0.5),
        "LambdaDecay": lambda: mod.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(
            0.1, lambda e: 0.9 if e % 2 else 0.99),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(0.1, 5,
                                                                 0.01),
        "OneCycleLR": lambda: mod.OneCycleLR(0.1, 10),
        "OneCycleLR_linear": lambda: mod.OneCycleLR(
            0.1, 10, anneal_strategy="linear", phase_pct=0.4),
        "CyclicLR": lambda: mod.CyclicLR(0.01, 0.1, 3),
        "CyclicLR_triangular2": lambda: mod.CyclicLR(
            0.01, 0.1, 2, 3, mode="triangular2"),
        "CyclicLR_exp_range": lambda: mod.CyclicLR(
            0.01, 0.1, 2, mode="exp_range", exp_gamma=0.9),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(
            0.1, patience=1, factor=0.5, cooldown=1),
    }


def _rates(sched, n=14):
    out = [sched()]
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.85, 0.86, 0.87, 0.88,
               0.89, 0.9, 0.91, 0.92]
    for i in range(n):
        if type(sched).__name__ == "ReduceOnPlateau":
            sched.step(metrics[i])
        else:
            sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_sequence_matches_jax(name):
    from paddle_tpu.optimizer import lr as jlr
    assert _rates(_schedulers(tlr)[name]()) == \
        _rates(_schedulers(jlr)[name]())


def test_all_fifteen_schedulers_are_ported():
    from paddle_tpu.optimizer import lr as jlr
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    assert len([n for n in tlr.__all__ if n != "LRScheduler"]) == 15


def test_optimizer_reads_and_saves_its_scheduler():
    import paddle_tpu as paddle
    from paddle_tpu.optimizer import Momentum as JMomentum
    from paddle_tpu.optimizer import lr as jlr
    w = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.1, 2, 0.5)
    opt = Momentum(sched, parameters=[w])
    jsched = jlr.StepDecay(0.1, 2, 0.5)
    jopt = JMomentum(jsched, parameters=paddle.nn.Linear(3, 1).parameters())
    for _ in range(5):
        sched.step()
        jsched.step()
    assert opt.get_lr() == jopt.get_lr() == 0.025
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    w.grad = torch.ones(3)
    opt.step()
    state = opt.state_dict()
    assert state["LR_Scheduler"] == jopt.state_dict()["LR_Scheduler"]
    fresh = tlr.StepDecay(0.1, 2, 0.5)
    opt2 = Momentum(fresh, parameters=[torch.nn.Parameter(torch.ones(3))])
    opt2.set_state_dict(state)
    assert fresh.last_epoch == 5 and opt2.get_lr() == 0.025
    assert torch.equal(opt2._slots(opt2._parameter_list[0])[0],
                       opt._slots(w)[0])


def test_trainstep_state_dict_round_trip_under_a_scheduler():
    """Three steps with the scheduler stepped after each; a fresh model,
    optimizer and scheduler restored from the state after the second
    repeat the third step bit for bit. ``set_state_dict`` keeps the
    scheduler's rate (no ``set_lr``)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.vision.models import LeNet

    def build():
        m = LeNet(device="cpu")
        sched = tlr.PiecewiseDecay([1, 2], [0.1, 0.05, 0.01])
        step = TrainStep(m, lambda layer, a, b: TF.cross_entropy(layer(a),
                                                                 b),
                         Momentum(sched, parameters=m.parameters()))
        return step, sched

    x, y = _rand((8, 1, 28, 28), 3), (np.arange(8) % 10).astype(np.int64)
    step, sched = build()
    losses = []
    for i in range(3):
        losses.append(float(step(x, y)))
        sched.step()
        if i == 1:
            state = step.state_dict()
    assert state["opt_state"]["LR_Scheduler"]["last_epoch"] == 2
    step2, sched2 = build()
    step2.set_state_dict(state)
    assert sched2.last_epoch == 2 and step2.optimizer.get_lr() == 0.01
    assert float(step2(x, y)) == losses[2]


def test_sgd_keeps_its_float_rate():
    w = torch.nn.Parameter(torch.ones(2))
    opt = SGD(0.5, parameters=[w])
    opt.set_lr(0.25)
    w.grad = torch.ones(2)
    opt.step()
    assert torch.equal(w.detach(), torch.full((2,), 0.75))
    assert "LR_Scheduler" not in opt.state_dict()


# -- datasets ------------------------------------------------------------------
DATASETS = [("MNIST", dict(num_synthetic=64)),
            ("MNIST", dict(mode="test", num_synthetic=64)),
            ("FashionMNIST", dict(num_synthetic=32)),
            ("Cifar10", dict(num_synthetic=48)),
            ("Cifar10", dict(mode="test", num_synthetic=48)),
            ("Cifar100", dict(num_synthetic=40)),
            ("Flowers", dict(num_synthetic=16))]


@pytest.mark.parametrize("case", range(len(DATASETS)))
def test_synthetic_samples_bit_equal_to_jax(case):
    from paddle_tpu.vision import datasets as jds
    name, kw = DATASETS[case]
    a, b = getattr(tds, name)(**kw), getattr(jds, name)(**kw)
    assert len(a) == len(b)
    for i in (0, 1, len(a) // 2, len(a) - 1):
        (xa, ya), (xb, yb) = a[i], b[i]
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))


def test_download_raises():
    with pytest.raises(RuntimeError, match="download"):
        tds.MNIST(download=True)
    with pytest.raises(RuntimeError, match="download"):
        tds.Cifar10(download=True)


def test_mnist_reads_idx_files_like_jax(tmp_path):
    from paddle_tpu.vision import datasets as jds
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    norm = tt.Normalize(0.5, 0.5)
    a = tds.MNIST(image_path=ip, label_path=lp, transform=norm)
    b = jds.MNIST(image_path=ip, label_path=lp, transform=norm)
    for i in range(5):
        np.testing.assert_array_equal(a[i][0], b[i][0])
        np.testing.assert_array_equal(a[i][1], b[i][1])


def test_dataset_folder_like_jax(tmp_path):
    from paddle_tpu.vision import datasets as jds
    for c, n in (("cat", 2), ("dog", 3)):
        (tmp_path / c).mkdir()
        for i in range(n):
            np.save(tmp_path / c / f"{i}.npy", _rand((3, 4, 4), i))
    a, b = tds.DatasetFolder(str(tmp_path)), jds.DatasetFolder(str(tmp_path))
    assert a.class_to_idx == b.class_to_idx and len(a) == len(b) == 5
    for i in range(5):
        np.testing.assert_array_equal(a[i][0], b[i][0])
        assert a[i][1] == b[i][1]


def test_dataloader_batches_synthetic_mnist():
    loader = DataLoader(tds.MNIST(num_synthetic=96), places="cpu",
                        batch_size=32, shuffle=False, drop_last=True)
    batches = list(loader)
    assert len(batches) == 3
    x, y = batches[0]
    assert tuple(x.shape) == (32, 1, 28, 28) and x.dtype == torch.float32
    assert tuple(y.shape) == (32, 1) and y.dtype == torch.int64


# -- transforms ----------------------------------------------------------------
def _both(make, img, seed=0):
    from paddle_tpu.vision import transforms as jt
    np.random.seed(seed)
    a = make(tt)(img)
    np.random.seed(seed)
    b = make(jt)(img)
    return np.asarray(a), np.asarray(b)


TRANSFORMS = [
    ("compose", lambda m: m.Compose([m.Normalize([0.5, 0.4, 0.3],
                                                 [0.2, 0.3, 0.4]),
                                     m.Transpose((1, 2, 0))]), "chw"),
    ("to_tensor", lambda m: m.ToTensor(), "hwc255"),
    ("center_crop", lambda m: m.CenterCrop(5), "chw"),
    ("pad", lambda m: m.Pad((1, 2, 3, 0), fill=0.5), "chw"),
    ("random_crop", lambda m: m.RandomCrop(6, padding=2), "chw"),
    ("hflip", lambda m: m.RandomHorizontalFlip(1.0), "chw"),
    ("vflip", lambda m: m.RandomVerticalFlip(1.0), "chw"),
    ("brightness", lambda m: m.BrightnessTransform(0.4), "chw"),
    ("contrast", lambda m: m.ContrastTransform(0.4), "chw"),
    ("saturation", lambda m: m.SaturationTransform(0.4), "chw"),
    ("hue", lambda m: m.HueTransform(0.2), "chw"),
    ("color_jitter", lambda m: m.ColorJitter(0.2, 0.2, 0.2, 0.1), "chw"),
    ("grayscale", lambda m: m.Grayscale(3), "chw"),
    ("rotation", lambda m: m.RandomRotation(30), "chw"),
    ("rotation_expand", lambda m: m.RandomRotation((10, 40), expand=True),
     "hwc"),
]


@pytest.mark.parametrize("case", range(len(TRANSFORMS)))
def test_transform_matches_jax(case):
    _, make, kind = TRANSFORMS[case]
    base = np.random.RandomState(case).rand(3, 9, 10).astype(np.float32)
    img = {"chw": base, "hwc": base.transpose(1, 2, 0),
           "hwc255": (base.transpose(1, 2, 0) * 255).round()}[kind]
    a, b = _both(make, img, seed=case)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,size", [((3, 32, 32), 16),
                                        ((3, 32, 32), 48),
                                        ((1, 28, 28), (20, 35)),
                                        ((30, 20, 3), (7, 9)),
                                        ((3, 17, 13), (17, 5))])
def test_resize_matches_jax_image_resize(shape, size):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    a, b = _both(lambda m: m.Resize(size), img)
    assert a.shape == b.shape and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_random_resized_crop_matches_jax():
    img = np.random.RandomState(1).rand(3, 24, 20).astype(np.float32)
    a, b = _both(lambda m: m.RandomResizedCrop(12), img, seed=4)
    assert a.shape == b.shape == (3, 12, 12)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert not math.isnan(float(a.sum()))


# -- the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(MOMENTUM_CASES)))
def test_momentum_on_card_matches_cpu(cuda, case):
    kw = MOMENTUM_CASES[case]
    w0, b0 = _rand((64, 33), 1), _rand((33,), 2)
    cots = [(_rand((64, 33), 10 + i), _rand((33,), 20 + i))
            for i in range(4)]
    ref = _torch_momentum_run(w0, b0, cots, **kw)
    got = _torch_momentum_run(w0, b0, cots, device=cuda, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
