"""``paddle_tpu_torch.hapi.Model``, the callbacks and the metrics against
the JAX package on the CPU.

A LeNet with the JAX model's weights goes through ``prepare`` (Momentum
under a ``StepDecay`` stepped by the ``LRScheduler`` callback,
``CrossEntropyLoss``, ``Accuracy(topk=(1, 3))``), ``fit`` over two
epochs, ``evaluate`` and ``predict`` beside the JAX ``Model`` on the same
arrays: per-batch losses within ``LOSS_RTOL`` relative, parameters within
``PARAM_TOL`` of their largest magnitude, the evaluation loss within
``LOSS_RTOL``, the accuracies equal, the predictions within
``PARAM_TOL``. ``save`` writes the JAX files (the JAX ``Model.load``
reads them back exactly), ``load`` restores the network and the
optimizer's slots, ``summary`` counts what JAX counts. The callbacks
(``EarlyStopping``, ``ModelCheckpoint``, ``LRScheduler`` by epoch,
``ProgBarLogger``, ``MonitorCallback``) behave as the JAX ones; the
metrics equal JAX's on the same arrays, exactly; the static mode makes
``prepare`` raise. The fleet (dp = 2) ``fit`` is in
``test_torch_vision_dp.py``.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu import metric as JM
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi import callbacks as JC
from paddle_tpu_torch import metric as TM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.flags import get_flag
from paddle_tpu_torch.monitor import scoped_registry
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as TC
from paddle_tpu_torch.models import load_jax_weights
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.optimizer.lr import StepDecay

import _torch_vision_workers as W

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
PARAM_FLOOR = 1e-7
LR = 0.05


@pytest.fixture(autouse=True)
def _no_jax_mesh():
    """The JAX package's fleet and global mesh are reset around each case
    (a JAX ``TrainStep`` on a mesh sets the mesh, and a module that ran
    ``fleet.init`` in a fixture leaves both): the JAX references here run
    on one device or on their own mesh."""
    with _without_jax_mesh():
        yield


@contextlib.contextmanager
def _without_jax_mesh():
    from paddle_tpu.distributed import fleet as jfleet
    jfleet.reset()
    try:
        yield
    finally:
        jfleet.reset()


def _max_rel(a, b, floor=0.0) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.maximum(np.abs(a - b) - floor, 0.0)
    return float(d.max() / max(np.abs(b).max(), 1e-12))


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 1, 28, 28)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


def _pair():
    from paddle_tpu.vision.models import LeNet as JLeNet
    from paddle_tpu_torch.vision.models import LeNet
    paddle.seed(0)
    jm = JLeNet()
    tm = LeNet(device="cpu")
    load_jax_weights(tm, {k: np.asarray(v._data)
                          for k, v in jm.state_dict().items()})
    return jm, tm


def _prepared():
    """The JAX and the port Models over the same LeNet, prepared alike."""
    import paddle_tpu.nn as jnn
    from paddle_tpu.optimizer import Momentum as JMomentum
    from paddle_tpu.optimizer.lr import StepDecay as JStepDecay
    jm, tm = _pair()
    jmodel = JModel(jm).prepare(
        JMomentum(JStepDecay(LR, step_size=2, gamma=0.5), momentum=0.9,
                  parameters=jm.parameters()),
        jnn.CrossEntropyLoss(), JM.Accuracy(topk=(1, 3)))
    tmodel = Model(tm).prepare(
        Momentum(StepDecay(LR, step_size=2, gamma=0.5), momentum=0.9,
                 parameters=tm.parameters()),
        tnn.CrossEntropyLoss(), TM.Accuracy(topk=(1, 3)))
    return jmodel, tmodel


def _losses_cb(base):
    class Record(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    return Record()


@pytest.fixture(scope="module")
def fitted():
    x, y = _data()
    jcb, tcb = _losses_cb(JC.Callback), _losses_cb(TC.Callback)
    with _without_jax_mesh():
        jmodel, tmodel = _prepared()
        for model, cb in ((jmodel, jcb), (tmodel, tcb)):
            model.fit(W.Arrays(x, y), batch_size=8, epochs=2,
                      shuffle=False, verbose=0, callbacks=[cb])
    return jmodel, tmodel, jcb.losses, tcb.losses


def _jstate(jmodel):
    """The JAX network's arrays (its compiled step's state synced in)."""
    if jmodel._train_step is not None:
        jmodel._train_step.sync_to_layer()
    return {k: np.asarray(v._data)
            for k, v in jmodel.network.state_dict().items()}


def test_fit_matches_jax(fitted):
    jmodel, tmodel, jl, tl = fitted
    assert len(tl) == 6
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    got = {k: v.numpy() for k, v in tmodel.network.state_dict().items()}
    for k, v in _jstate(jmodel).items():
        assert _max_rel(got[k], v, PARAM_FLOOR) < PARAM_TOL, k
    # the LRScheduler callback stepped the scheduler once a batch
    assert tmodel._optimizer._lr.last_epoch == 6
    assert tmodel._optimizer.get_lr() == pytest.approx(LR * 0.5 ** 3)


def test_evaluate_and_predict_match_jax(fitted):
    jmodel, tmodel = fitted[:2]
    x, y = _data(16, seed=1)
    je = jmodel.evaluate(W.Arrays(x, y), batch_size=8, verbose=0)
    te = tmodel.evaluate(W.Arrays(x, y), batch_size=8, verbose=0)
    assert set(te) == set(je) == {"loss", "acc_top1", "acc_top3"}
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=LOSS_RTOL)
    assert te["acc_top1"] == je["acc_top1"]
    assert te["acc_top3"] == je["acc_top3"]
    jp = jmodel.predict(W.Arrays(x, y), batch_size=5)
    tpred = tmodel.predict(W.Arrays(x, y), batch_size=5)
    assert [len(b) for b in tpred] == [len(b) for b in jp]
    assert [b[0].shape for b in tpred] == [b[0].shape for b in jp]
    stacked = tmodel.predict(W.Arrays(x, y), batch_size=5,
                             stack_outputs=True)[0]
    assert _max_rel(stacked, np.concatenate([b[0] for b in jp])) < PARAM_TOL
    one = tmodel.predict_batch([torch.tensor(x[:2])])[0]
    np.testing.assert_array_equal(one, stacked[:2])


def test_save_and_load_round_trip_and_cross_packages(fitted, tmp_path):
    jmodel, tmodel = fitted[:2]
    path = str(tmp_path / "lenet")
    tmodel.save(path)
    # the JAX Model reads the port's files: network and optimizer slots
    j2, t2 = _prepared()
    j2.load(path)
    for k, v in _jstate(j2).items():
        np.testing.assert_array_equal(
            v, tmodel.network.state_dict()[k].numpy(), err_msg=k)
    t2.load(path)
    for k, v in tmodel.network.state_dict().items():
        assert torch.equal(t2.network.state_dict()[k], v), k
    for k, v in tmodel._optimizer.state_dict().items():
        got = t2._optimizer.state_dict()[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(got, v), k
    x, y = _data(8, seed=2)
    # the loaded model continues as the saved one does
    np.testing.assert_allclose(t2.train_batch([x], [y]),
                               tmodel.train_batch([x], [y]), rtol=1e-6)
    tmodel.save(str(tmp_path / "infer"), training=False)
    assert not (tmp_path / "infer.pdopt").exists()


def test_summary_counts_what_jax_counts(capsys):
    jm, tm = _pair()
    want = JModel(jm).summary()
    got = Model(tm).summary()
    assert got == want
    assert "features.0" in capsys.readouterr().out


def test_callbacks_behave_as_jax(tmp_path, capsys):
    """EarlyStopping stops when the monitored loss stops falling;
    ModelCheckpoint writes every ``save_freq`` epoch and ``final``;
    LRScheduler(by_epoch) steps once an epoch; ProgBarLogger prints a
    line every ``log_freq`` batches; MonitorCallback appends one JSONL
    snapshot of the registry an epoch and one at the end."""
    x, y = _data(16)
    _, tmodel = _prepared()
    stop = TC.EarlyStopping(monitor="loss", patience=0, min_delta=1e9)
    ck = TC.ModelCheckpoint(save_freq=1, save_dir=str(tmp_path / "ck"))
    sched = TC.LRScheduler(by_step=False, by_epoch=True)
    mon = TC.MonitorCallback(str(tmp_path / "mon.jsonl"))
    with scoped_registry():
        tmodel.fit(W.Arrays(x, y), batch_size=8, epochs=5, shuffle=False,
                   verbose=1, log_freq=1, callbacks=[stop, ck, sched, mon])
    # the first epoch sets the best, the second stops (no 1e9 drop)
    assert tmodel.stop_training
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    # the by-step default LRScheduler (config_callbacks appends none:
    # one is given) is not there; by_epoch stepped twice
    assert tmodel._optimizer._lr.last_epoch == 2
    out = capsys.readouterr().out
    assert "Epoch 0 step 0: loss=" in out and "Epoch 1 done in" in out
    lines = [json.loads(s) for s in open(tmp_path / "mon.jsonl")]
    assert {r.get("epoch", r.get("event")) for r in lines} == {
        0, 1, "train_end"}
    assert any(r["name"].startswith("train_step") for r in lines)
    assert not get_flag("monitor")          # held on across fit only
    cbs = TC.config_callbacks([stop], model=tmodel, verbose=0,
                              save_dir=str(tmp_path))
    kinds = [type(c).__name__ for c in cbs.callbacks]
    jkinds = [type(c).__name__ for c in JC.config_callbacks(
        [JC.EarlyStopping()], model=None, verbose=0,
        save_dir=str(tmp_path)).callbacks]
    assert kinds == jkinds == ["EarlyStopping", "LRScheduler",
                               "ModelCheckpoint"]


def test_metrics_equal_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(40, 7)).astype(np.float32)
    label = rng.integers(0, 7, (40, 1)).astype(np.int64)
    for topk in ((1,), (1, 3, 5)):
        ja, ta = JM.Accuracy(topk=topk), TM.Accuracy(topk=topk)
        for sl in (slice(0, 25), slice(25, 40)):
            jc = ja.compute(paddle.to_tensor(pred[sl]),
                            paddle.to_tensor(label[sl]))
            tc = ta.compute(torch.tensor(pred[sl]), torch.tensor(label[sl]))
            np.testing.assert_array_equal(tc, np.asarray(jc))
            assert ta.update(tc) == ja.update(jc)
        assert ta.accumulate() == ja.accumulate()
        assert ta.name() == ja.name()
    probs = rng.uniform(size=(60,)).astype(np.float32)
    labels = rng.integers(0, 2, (60,)).astype(np.int64)
    for J, T in ((JM.Precision, TM.Precision), (JM.Recall, TM.Recall),
                 (JM.Auc, TM.Auc)):
        jm_, tm_ = J(), T()
        for sl in (slice(0, 30), slice(30, 60)):
            jm_.update(probs[sl], labels[sl])
            tm_.update(torch.tensor(probs[sl]), torch.tensor(labels[sl]))
        assert tm_.accumulate() == jm_.accumulate()
        assert tm_.name() == jm_.name()
    two = np.stack([1 - probs, probs], 1)
    ja, ta = JM.Auc(num_thresholds=255), TM.Auc(num_thresholds=255)
    ja.update(two, labels)
    ta.update(two, labels)
    assert ta.accumulate() == ja.accumulate()
    for k in (1, 2):
        got = float(TM.accuracy(torch.tensor(pred), torch.tensor(label), k))
        want = float(JM.accuracy(paddle.to_tensor(pred),
                                 paddle.to_tensor(label), k))
        assert got == want


def test_static_mode_makes_prepare_raise():
    _, tm = _pair()
    tp.enable_static()
    try:
        assert not tp.in_dynamic_mode()
        with pytest.raises(NotImplementedError, match="static"):
            Model(tm).prepare(Momentum(0.1, parameters=tm.parameters()),
                              tnn.CrossEntropyLoss())
    finally:
        tp.disable_static()
    assert tp.in_dynamic_mode()
