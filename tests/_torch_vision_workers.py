"""Rank bodies for the port's data-parallel vision tests
(``test_torch_vision_dp.py``).

One gloo world of ``N`` ranks runs the file's cases in order (``run``,
as in ``_torch_dist_workers``) and pickles each rank's results; the
tests hold them against the JAX package in the parent. This module
imports torch and the port only, so a rank never loads JAX.
"""

import os

from _torch_dist_workers import run as _run

N = 2            # ranks of the world: dp = 2
WORLD_BUDGET_S = 240
LR = 0.1


def run(out_dir: str, cases) -> None:
    """One rank of the world over this module's cases; a rank still
    running after ``WORLD_BUDGET_S`` writes its stack to ``hung<r>.txt``
    and exits."""
    import faulthandler
    import _torch_dist_workers
    hung = open(os.path.join(out_dir, f"hung{os.environ['RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(WORLD_BUDGET_S, exit=True, file=hung)
    _torch_dist_workers.CASES.update(CASES)
    _run(out_dir, cases)
    faulthandler.cancel_dump_traceback_later()


def _fleet_dp():
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": N, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    return fleet.get_hybrid_communicate_group()


def bn_model(weights=None, sync=False):
    """The small BatchNorm model of the tests (conv, BN, relu, pool,
    linear), with the JAX model's ``weights``; every BN converted by
    ``SyncBatchNorm.convert_sync_batchnorm`` with ``sync``."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import load_jax_weights
    m = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, device="cpu"),
                      nn.BatchNorm2D(8, device="cpu"), nn.ReLU(),
                      nn.Conv2D(8, 8, 3, padding=1, device="cpu"),
                      nn.BatchNorm2D(8, device="cpu"), nn.ReLU(),
                      nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                      nn.Linear(8, 10, device="cpu"))
    if weights is not None:
        load_jax_weights(m, weights)
    if sync:
        m = nn.SyncBatchNorm.convert_sync_batchnorm(m)
    return m


def _state(m) -> dict:
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def _ce(layer, xb, yb):
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(layer(xb), yb)


def _train(inputs, mode: str) -> dict:
    """Two Momentum steps of the BN model over dp on the global batch:
    ``plain`` BatchNorm, ``sync`` (converted), ``axis`` (converted, under
    ``set_data_axis("dp")``: the JAX SyncBatchNorm recipe)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    hcg = _fleet_dp()
    m = bn_model(inputs["weights"], sync=mode != "plain")
    if mode == "axis":
        env.set_data_axis("dp")
    try:
        step = TrainStep(m, _ce, Momentum(LR, momentum=0.9,
                                          parameters=m.parameters()),
                         mesh=hcg.mesh, data_spec=P("dp"))
        x, y = inputs["batch"]
        losses = [float(step(x, y)) for _ in range(2)]
    finally:
        env.set_data_axis(None)
    bns = [b for b in m.modules() if isinstance(b, nn.layers.norm
                                                ._BatchNormBase)]
    return {"losses": losses, "state": _state(m),
            "sync": all(isinstance(b, nn.SyncBatchNorm) for b in bns),
            "groups": [len(b._data_groups) for b in bns]}


class Arrays:
    """A map-style dataset over numpy arrays (rows of each)."""

    def __init__(self, *arrays):
        self.arrays = arrays

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


def _hapi_fit(inputs) -> dict:
    """``Model.fit`` under ``fleet.init`` (dp = 2): two epochs of the
    global batches, the scheduler stepped by the LRScheduler callback,
    then ``evaluate`` and ``predict`` on every rank."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.optimizer.lr import StepDecay
    _fleet_dp()
    losses, lrs = [], []

    class Record(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            lrs.append(self.model._optimizer.get_lr())

    net = bn_model(inputs["weights"], sync=True)
    model = Model(net)
    model.prepare(Momentum(StepDecay(LR, step_size=2, gamma=0.5),
                           momentum=0.9, parameters=net.parameters()),
                  nn.CrossEntropyLoss(), Accuracy(topk=(1, 2)))
    x, y = inputs["fit_data"]
    model.fit(Arrays(x, y), batch_size=8, epochs=2, shuffle=False,
              verbose=0, callbacks=[Record()])
    ev = model.evaluate(Arrays(x, y), batch_size=8, verbose=0)
    pred = model.predict(Arrays(x[:6], y[:6]), batch_size=4,
                         stack_outputs=True)
    return {"losses": losses, "lrs": lrs, "eval": ev, "pred": pred[0],
            "state": _state(net)}


CASES = {
    "plain": lambda rank, inputs, out: _train(inputs, "plain"),
    "sync": lambda rank, inputs, out: _train(inputs, "sync"),
    "axis": lambda rank, inputs, out: _train(inputs, "axis"),
    "hapi_fit": lambda rank, inputs, out: _hapi_fit(inputs),
}
