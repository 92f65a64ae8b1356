"""High-level Model API: counterpart of ``paddle_tpu/hapi/model.py``
(``Model`` :133-370) in the dynamic mode.

``prepare(optimizer, loss, metrics)`` builds a ``jit.TrainStep`` over
``loss(network(*inputs), label)``. With ``fleet.init`` active the step
is fleet-distributed as the JAX one is (:172-190): the optimizer goes
through ``fleet.distributed_optimizer`` and the step is laid over the
hybrid mesh with the batch cut on dp (``data_spec=P("dp")``). Each rank
process then runs ``fit`` over the same loader: every call hands the
step the GLOBAL batch and the step keeps the rank's rows
(``TrainStep._local_batch``), its batch norms taking statistics over the
whole global batch; the loss ``train_batch`` returns is the global
batch's, the same on every rank. ``eval_batch`` / ``predict_batch`` run
the network eagerly in eval mode on the whole batch (:216-252), so every
rank computes the same outputs and its metrics the same results.

Batches are numpy arrays or tensors; they are placed on the network's
device (``DataLoader`` built here takes it as ``places``). ``save`` /
``load`` write and read ``path.pdparams`` (the network's state dict) and
``path.pdopt`` (the optimizer's) through ``framework.io``, the JAX files'
format. The static mode (``paddle_tpu_torch.enable_static()``) needs the
JAX ``StaticGraphAdapter`` (:30-131), which needs ``static/``, not
ported: ``prepare`` raises ``NotImplementedError`` then.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..io.dataloader import DataLoader
from ..jit.to_static import TrainStep
from ..metric import Metric
from . import callbacks as cbks_mod

__all__ = ["Model"]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs if inputs is None or isinstance(
            inputs, (list, tuple)) else [inputs]
        self._labels = labels if labels is None or isinstance(
            labels, (list, tuple)) else [labels]
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        from .. import framework
        if not framework.in_dynamic_mode():
            raise NotImplementedError(
                "Model.prepare in the static mode needs the static-graph "
                "adapter (StaticGraphAdapter), which needs static/; not "
                "ported: call paddle_tpu_torch.disable_static()")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        else:
            self._metrics = []
        if optimizer is not None and loss is not None:
            loss_layer = loss

            def loss_fn(net, *batch):
                # convention: the last element is the label
                *xs, y = batch
                return loss_layer(net(*xs), y)

            from ..distributed import fleet
            if fleet.init_is_called():
                from ..distributed.spmd import P
                hcg = fleet.get_hybrid_communicate_group()
                if not hasattr(optimizer, "_fleet_strategy"):
                    optimizer = fleet.distributed_optimizer(optimizer)
                self._train_step = TrainStep(
                    self.network, loss_fn, optimizer, mesh=hcg.mesh,
                    data_spec=P("dp"))
            else:
                self._train_step = TrainStep(self.network, loss_fn,
                                             optimizer)
        return self

    # ------------------------------------------------------------------
    def forward(self, *inputs):
        """Delegate to the wrapped network."""
        return self.network(*inputs)

    @property
    def mode(self):
        return "train" if self.network.training else "eval"

    @mode.setter
    def mode(self, value):
        self.network.train() if value == "train" else self.network.eval()

    def _place(self, xs) -> list:
        dev = self._device
        return [x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev) for x in xs]

    def train_batch(self, inputs, labels=None, update=True):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is None or isinstance(
            labels, (list, tuple)) else [labels]
        batch = list(inputs) + (list(labels) if labels else [])
        self.network.train()
        loss = self._train_step(*batch)
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.network.eval()
        outputs = self.network(*self._place(inputs))
        metrics = []
        if labels is not None:
            labels_l = labels if isinstance(labels, (list, tuple)) \
                else [labels]
            label = self._place(labels_l[:1])[0]
            if self._loss is not None:
                metrics.append(float(self._loss(outputs, label)))
            for m in self._metrics:
                m.update(m.compute(outputs, label))
        return metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.network.eval()
        out = self.network(*self._place(inputs))
        if isinstance(out, (list, tuple)):
            return [o.detach().cpu().numpy() for o in out]
        return [out.detach().cpu().numpy()]

    # ------------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle=False, drop_last=False,
                num_workers=0):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, places=self._device, batch_size=batch_size,
                          shuffle=shuffle, drop_last=drop_last,
                          num_workers=num_workers)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        eval_loader = None
        if eval_data is not None:
            eval_loader = self._loader(eval_data, batch_size,
                                       num_workers=num_workers)
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, verbose=verbose,
            steps=len(train_loader) if hasattr(train_loader, "__len__")
            else None,
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            metrics=["loss"] + [n for m in self._metrics
                                for n in (m.name() if isinstance(
                                    m.name(), list) else [m.name()])])
        cbks.on_begin("train")
        # on_end runs even when training dies mid-epoch, so callbacks
        # that took process state in on_begin give it back
        try:
            steps_done = 0
            logs = {}
            for epoch in range(epochs):
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                for step, batch in enumerate(train_loader):
                    cbks.on_batch_begin("train", step, {})
                    batch = batch if isinstance(batch, (tuple, list)) \
                        else [batch]
                    *xs, y = batch
                    losses = self.train_batch(xs, [y])
                    logs = {"loss": losses[0], "step": step}
                    cbks.on_batch_end("train", step, logs)
                    steps_done += 1
                    if num_iters is not None and steps_done >= num_iters:
                        break
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_loader, verbose=0)
                if self.stop_training or (num_iters is not None
                                          and steps_done >= num_iters):
                    break
        finally:
            cbks.on_end("train")
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            batch = batch if isinstance(batch, (tuple, list)) else [batch]
            *xs, y = batch
            out = self.eval_batch(xs, [y])
            if out:
                losses.append(out[0])
        result = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for n, v in zip(names, vals):
                result[n] = v
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size,
                              num_workers=num_workers)
        outputs = []
        for batch in loader:
            batch = batch if isinstance(batch, (tuple, list)) else [batch]
            xs = batch[:-1] if len(batch) > 1 else batch
            outputs.append(self.predict_batch(list(xs)))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as _save
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        import os
        from ..framework.io import load as _load
        state = _load(path + ".pdparams")
        self.network.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(
                {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                 for k, v in _load(path + ".pdopt").items()})
        if self._train_step is not None:
            # a fresh step over the loaded layer, as the JAX one re-seeds
            # its compiled step's state from it
            self._train_step = TrainStep(
                self.network, self._train_step.loss_fn, self._optimizer,
                mesh=self._train_step.mesh,
                data_spec=self._train_step.data_spec)

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
