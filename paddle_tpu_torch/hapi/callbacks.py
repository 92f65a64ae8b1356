"""Callbacks: counterpart of ``paddle_tpu/hapi/callbacks.py``, the same
classes and hooks. ``LRScheduler`` steps the scheduler the optimizer
was given as its learning rate (``optimizer.lr.LRScheduler``) after every
training batch (``by_step``) or epoch (``by_epoch``); ``MonitorCallback``
streams the port's metrics registry (``monitor``) to a JSONL file at
every epoch end, holding ``FLAGS_monitor`` on across the run."""

from __future__ import annotations

import os
import time
from typing import List

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "MonitorCallback", "config_callbacks",
           "CallbackList"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()
        self.seen = 0

    def on_train_batch_end(self, step, logs=None):
        self.seen += 1
        if self.verbose and step % self.log_freq == 0:
            loss = logs.get("loss") if logs else None
            msg = f"Epoch {self.epoch} step {step}"
            if loss is not None:
                msg += f": loss={loss:.4f}"
            print(msg)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch} done in {time.time() - self.t0:.1f}s")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None) if opt else None
        from ..optimizer.lr import LRScheduler as Sched
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class MonitorCallback(Callback):
    """Stream the monitor metrics registry to an append-only JSONL file
    (paddle_tpu.monitor; render with ``tools/monitor_report.py``).

    Every epoch end appends the full registry snapshot tagged with the
    epoch number (plus a final ``event="train_end"`` snapshot), so the
    file is a per-epoch time series of counters — recompiles, comms
    bytes, step-time histograms — for the whole fit() run. The registry
    is resolved at dump time, so ``monitor.scoped_registry`` blocks and
    late ``FLAGS_monitor`` flips are honored.
    """

    def __init__(self, path, registry=None, set_monitor_flag=True):
        super().__init__()
        self.path = path
        self._registry = registry
        self._set_flag = set_monitor_flag
        self._flag_scope = None

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ..monitor import get_registry
        return get_registry()

    def _dump(self, extra):
        try:
            self._reg().dump_jsonl(self.path, extra=extra)
        except OSError as e:          # telemetry must never kill training
            print(f"MonitorCallback: dump to {self.path} failed: {e}")

    def on_train_begin(self, logs=None):
        if self._set_flag and self._flag_scope is None:
            # flag_scope is the restore-capable override (keeps the
            # explicitly-set bit); held open across the fit() run —
            # Model.fit guarantees on_end("train") via its finally
            from ..core.flags import flag_scope
            self._flag_scope = flag_scope("monitor", True)
            self._flag_scope.__enter__()

    def on_epoch_end(self, epoch, logs=None):
        self._dump({"epoch": epoch})

    def on_train_end(self, logs=None):
        self._dump({"event": "train_end"})
        if self._flag_scope is not None:
            self._flag_scope.__exit__(None, None, None)
            self._flag_scope = None


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or []})
    return cl
