"""BatchNorm over the global batch on a data-parallel mesh, and
``hapi.Model.fit`` under ``fleet.init``, against the JAX package on the
CPU.

One gloo world of two ranks (``tests/_torch_vision_workers.py``) trains
a small BatchNorm model (two conv + BN pairs) two float32 Momentum steps
at dp = 2 through ``TrainStep(mesh=hcg.mesh, data_spec=P("dp"))`` on the
global batch: with plain ``BatchNorm2D``, with every BN converted by
``SyncBatchNorm.convert_sync_batchnorm``, and converted under
``distributed.env.set_data_axis("dp")`` (the JAX SyncBatchNorm's own
``E[x^2] - mean^2`` recipe over the dp group). The reference is the JAX
``TrainStep`` on a dp = 2 virtual-device mesh with the same weights and
batch (it runs such a model under jax 0.9.0, its statistics over the
global batch through GSPMD). Then ``Model(...).prepare(Momentum under
StepDecay, CrossEntropyLoss(), Accuracy(topk=(1, 2))).fit`` over the
same world, against the JAX ``Model.fit`` on one device.

Tolerances: losses within ``LOSS_RTOL`` relative; parameters and BN
running statistics within ``PARAM_TOL`` of their largest magnitude
(differences under ``PARAM_FLOOR`` absolute count as none); the running
statistics and parameters bit-equal on both ranks; the ``Accuracy`` of
``evaluate`` equal on both ranks and to JAX's.
"""

import contextlib
import pickle

import numpy as np
import pytest

from paddle_tpu_torch.distributed.spawn_mod import spawn

import _torch_vision_workers as W

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
PARAM_FLOOR = 1e-7


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


def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu import nn
    paddle.seed(0)
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                         nn.ReLU(), nn.Conv2D(8, 8, 3, padding=1),
                         nn.BatchNorm2D(8), nn.ReLU(),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(8, 10))


def _arrays(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _inputs():
    rng = np.random.default_rng(0)
    return {"weights": _arrays(_jax_model()),
            "batch": (rng.normal(size=(8, 3, 12, 12)).astype(np.float32),
                      (np.arange(8) % 10).astype(np.int64)),
            "fit_data": (rng.normal(size=(16, 3, 12, 12)).astype(np.float32),
                         rng.integers(0, 10, 16).astype(np.int64))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("vision_dp_world")
    with _without_jax_mesh():
        inputs = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_vision_workers:run", args=(str(out), list(W.CASES)),
          nprocs=W.N)
    ranks = []
    for r in range(W.N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _case(world, name):
    res = [r[name] for r in world[1]]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


def _max_rel(a, b, floor=0.0) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.maximum(np.abs(a - b) - floor, 0.0)
    return float(d.max() / max(np.abs(b).max(), 1e-12))


def _jax_reference(inputs):
    """Two JAX TrainStep steps on a dp = 2 virtual-device mesh."""
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed.spmd import make_mesh
    from paddle_tpu.jit import TrainStep as JTrainStep
    from paddle_tpu.optimizer import Momentum as JMomentum
    jm = _jax_model()
    mesh = make_mesh({"dp": 2}, jax.devices()[:2])
    step = JTrainStep(jm, lambda m, a, b: JF.cross_entropy(m(a), b),
                      JMomentum(W.LR, momentum=0.9,
                                parameters=jm.parameters()),
                      mesh=mesh, data_spec=JP("dp"))
    x, y = inputs["batch"]
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(2)]
    step.sync_to_layer()
    return losses, _arrays(jm)


@pytest.fixture(scope="module")
def reference(world):
    with _without_jax_mesh():
        return _jax_reference(world[0])


def _holds(res, ref_losses, ref_state):
    for r in res:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=LOSS_RTOL)
        for k, v in ref_state.items():
            assert _max_rel(r["state"][k], v, PARAM_FLOOR) < PARAM_TOL, k
    a, b = res
    assert a["losses"] == b["losses"]
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)
    assert not np.allclose(a["state"]["1._variance"], 1.0)


def test_batch_norm_model_on_a_data_parallel_mesh_trains_to_the_reference(
        world, reference):
    """Plain BatchNorm2D layers learn the mesh's dp group from the step
    and take the global batch's statistics: the JAX dp step's losses,
    parameters and running statistics, the same on both ranks."""
    res = _case(world, "plain")
    assert all(r["groups"] == [1, 1] and not r["sync"] for r in res)
    _holds(res, *reference)


def test_converted_sync_batch_norm_trains_to_the_reference(world,
                                                           reference):
    res = _case(world, "sync")
    assert all(r["sync"] for r in res)
    _holds(res, *reference)


def test_sync_batch_norm_under_set_data_axis_trains_to_the_reference(
        world, reference):
    """The JAX SyncBatchNorm recipe (``E[a^2] - mean^2`` averaged over the
    dp group by a differentiable all-reduce) gives the global-batch
    statistics too, to f32 rounding."""
    _holds(_case(world, "axis"), *reference)


def test_model_fit_under_fleet_matches_jax_model_fit(world):
    import paddle_tpu.nn as jnn
    from paddle_tpu.hapi import Model as JModel
    from paddle_tpu.hapi.callbacks import Callback as JCallback
    from paddle_tpu.metric import Accuracy as JAccuracy
    from paddle_tpu.optimizer import Momentum as JMomentum
    from paddle_tpu.optimizer.lr import StepDecay as JStepDecay
    res = _case(world, "hapi_fit")
    losses, lrs = [], []

    class Record(JCallback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            lrs.append(self.model._optimizer.get_lr())

    jm = jnn.SyncBatchNorm.convert_sync_batchnorm(_jax_model())
    model = JModel(jm)
    model.prepare(JMomentum(JStepDecay(W.LR, step_size=2, gamma=0.5),
                            momentum=0.9, parameters=jm.parameters()),
                  jnn.CrossEntropyLoss(), JAccuracy(topk=(1, 2)))
    x, y = world[0]["fit_data"]
    model.fit(W.Arrays(x, y), batch_size=8, epochs=2, shuffle=False,
              verbose=0, callbacks=[Record()])
    ev = model.evaluate(W.Arrays(x, y), batch_size=8, verbose=0)
    pred = model.predict(W.Arrays(x[:6], y[:6]), batch_size=4,
                         stack_outputs=True)[0]
    state = _arrays(jm)
    for r in res:
        assert len(r["losses"]) == 4
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["lrs"], lrs, rtol=1e-12)
        np.testing.assert_allclose(r["eval"]["loss"], ev["loss"],
                                   rtol=LOSS_RTOL)
        assert r["eval"]["acc_top1"] == ev["acc_top1"]
        assert r["eval"]["acc_top2"] == ev["acc_top2"]
        assert _max_rel(r["pred"], pred) < PARAM_TOL
        for k, v in state.items():
            assert _max_rel(r["state"][k], v, PARAM_FLOOR) < PARAM_TOL, k
    a, b = res
    assert a["eval"] == b["eval"] and a["losses"] == b["losses"]
    np.testing.assert_array_equal(a["pred"], b["pred"])
