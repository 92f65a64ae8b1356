"""LocalSGD / AdaptiveLocalSGD training step.

Counterpart of ``paddle_tpu/distributed/fleet/meta_optimizers.py``
(``LocalSGDTrainStep``, ``:27``; the reference's
``localsgd_optimizer.py``: k local steps between parameter averages,
and AdaComm's ``k_t = ceil(k_0 * sqrt(F(w_t) / F(w_0)))``). The JAX
step holds a replica axis of parameter copies sharded over ``dp`` and
runs the local step inside ``shard_map``; in the port each rank of the
``dp`` group is a replica holding its own parameters and optimizer
slots: a call runs one forward, backward and update on the rank's rows
of the global batch with no collective on the gradients, and every
``k_steps``-th call averages the parameters over the group (one
all-reduce of the flattened floating parameters a dtype). The loss
returned is the replicas' mean, and floating buffers are averaged every
call, as in JAX. dp-only, as in JAX: the parameters must be replicated
modulo the replica axis.

``TrainStep(layer, loss_fn, optimizer)`` builds this step when the
strategy snapshot ``fleet.distributed_optimizer`` attached to the
optimizer sets ``localsgd`` (``localsgd_configs['k_steps']``) or
``adaptive_localsgd`` (``adaptive_localsgd_configs['init_k_steps']``),
with the JAX dispatch's refusals (:func:`localsgd_from_strategy`).
Dropout in a local step draws from the step's generator with the
rank's rows' batch base, so a replica drops the single-process step's
masks of its rows (the JAX step folds the replica index into its key).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["LocalSGDTrainStep", "localsgd_from_strategy"]


class LocalSGDTrainStep:
    """One local step on each replica's own parameters a call (the
    global batch split over ``axis``); every ``k_steps``-th call also
    averages the parameters across replicas. ``adaptive=True`` re-derives
    k from the loss ratio at every sync (AdaComm)."""

    def __init__(self, layer, loss_fn: Callable, optimizer, mesh,
                 k_steps: int = 1, axis: str = "dp",
                 adaptive: bool = False, min_k_steps: int = 1,
                 max_k_steps: int = 16, seed: int = 0):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        sharded = [a for a in mesh.axis_names
                   if a != axis and mesh.axis_size(a) > 1]
        if sharded:
            raise NotImplementedError(
                f"LocalSGD runs over {axis!r} only (the parameters must be "
                f"replicated modulo the replica axis); the mesh also has "
                f"{sharded}")
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.group(axis)
        self.k_steps = max(1, int(k_steps))
        self.adaptive = adaptive
        self.min_k = max(1, int(min_k_steps))
        self.max_k = int(max_k_steps)
        self._k0 = self.k_steps
        self._loss0: Optional[float] = None
        self.step_count = 0
        self._stats = {"localsgd_syncs": 0, "local_steps": 0}
        self.num_replicas = mesh.axis_size(axis)
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(seed))
        self.device = next(iter(layer.parameters())).device
        # every replica starts from the group's first rank's parameters
        from ..collective import broadcast
        with torch.no_grad():
            for p in layer.parameters():
                broadcast(p.data, self.group.ranks[0], self.group)
        optimizer.init_state()

    def _rows(self, b) -> torch.Tensor:
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        n = self.num_replicas
        if b.shape[0] % n:
            raise ValueError(f"batch dim {b.shape[0]} not divisible by "
                             f"{n} replicas")
        rows = b.shape[0] // n
        r = self.group.rank
        return b[r * rows:(r + 1) * rows].to(self.device)

    @torch.no_grad()
    def _average(self, tensors) -> None:
        """Average float tensors over the replica group, flattened a
        dtype at a time."""
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        from ..collective import ReduceOp, all_reduce
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            if t.is_floating_point():
                by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = all_reduce(_flatten_dense_tensors(ts), ReduceOp.AVG,
                              self.group)
            for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(r)

    def __call__(self, *batch) -> torch.Tensor:
        from ...core.random import dropout_generator
        from ..collective import ReduceOp, all_reduce
        rows = [self._rows(b) for b in batch]
        self.step_count += 1
        base = self.group.rank * rows[0].shape[0]
        with dropout_generator(self.generator, base):
            loss = self.loss_fn(self.layer, *rows)
        loss.backward()
        for p in self.layer.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step(step=self.step_count)
        self.optimizer.clear_grad()
        self._average(list(self.layer.buffers()))
        loss = all_reduce(loss.detach().float().clone(), ReduceOp.AVG,
                          self.group)
        # the loss is read on the host only when AdaComm needs it
        if self.adaptive and self._loss0 is None:
            self._loss0 = max(float(loss), 1e-12)
        self._stats["local_steps"] += 1
        if self.step_count % self.k_steps == 0:
            self._stats["localsgd_syncs"] += 1
            from ...core.flags import get_flag
            if get_flag("monitor"):
                from ...monitor import get_registry
                reg = get_registry()
                reg.counter("localsgd_syncs_total",
                            "LocalSGD parameter-averaging boundaries"
                            ).inc(axis=self.axis)
                reg.gauge("localsgd_k_steps",
                          "current LocalSGD sync period (AdaComm adapts "
                          "this)").set(self.k_steps, axis=self.axis)
            self._average([p.data for p in self.layer.parameters()])
            if self.adaptive:
                k = math.ceil(self._k0 * math.sqrt(
                    max(float(loss), 1e-12) / self._loss0))
                self.k_steps = min(max(k, self.min_k), self.max_k)
        return loss

    def stats(self) -> dict:
        """Local steps, parameter-averaging syncs, and the current and
        initial k."""
        d = dict(self._stats)
        d.update(steps=self.step_count, k_steps=self.k_steps,
                 initial_k_steps=self._k0, num_replicas=self.num_replicas)
        return d

    def sync_to_layer(self) -> None:
        """Average the replicas' parameters now (the layer holds this
        replica's)."""
        self._average([p.data for p in self.layer.parameters()])


def localsgd_from_strategy(layer, loss_fn, optimizer, strat, args,
                           kwargs) -> LocalSGDTrainStep:
    """The LocalSGD step ``TrainStep(...)`` builds from a strategy with
    ``localsgd`` or ``adaptive_localsgd`` (after ``fleet.init``), with
    the JAX dispatch's refusals: gradient merge, and arguments the step
    cannot honor."""
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError(
            "strategy.localsgd requires fleet.init() first (the dp "
            "axis holds the replicas)")
    if strat.gradient_merge:
        raise NotImplementedError(
            "strategy combines localsgd with gradient_merge; the LocalSGD "
            "step does not accumulate gradients — pick one (the "
            "reference's meta-optimizer chain rejects this pairing too)")
    unsupported = {k: v for k, v in kwargs.items()
                   if k not in ("mesh", "data_spec", "seed") and
                   v is not None and v is not True}
    if args or unsupported:
        raise TypeError(
            "strategy.localsgd builds a LocalSGDTrainStep, which does not "
            f"accept {list(unsupported) or 'positional'} arguments "
            "(zero_axis/grad_accum_*/check_numerics); construct "
            "distributed.fleet.meta_optimizers.LocalSGDTrainStep directly "
            "for custom wiring")
    adaptive = bool(strat.adaptive_localsgd)
    cfg = (strat.adaptive_localsgd_configs if adaptive
           else strat.localsgd_configs)
    k = int(cfg.get("init_k_steps" if adaptive else "k_steps", 1))
    return LocalSGDTrainStep(layer, loss_fn, optimizer,
                             kwargs.get("mesh") or hcg.mesh, k_steps=k,
                             axis="dp", adaptive=adaptive,
                             seed=int(kwargs.get("seed") or 0))
