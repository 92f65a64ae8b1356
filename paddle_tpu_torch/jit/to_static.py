"""TrainStep: one eager training step over (model, loss, optimizer).

Counterpart of ``paddle_tpu/jit/to_static.py::TrainStep`` (:300) for one
device. The JAX class compiles the forward, backward and update into one
donated XLA program; here they run eagerly: ``loss_fn(layer, *batch)``,
``loss.backward()``, the optimizer's in-place update and
``clear_grad()``. A trainable parameter that the loss did not reach gets
a zero gradient before the update, as ``jax.value_and_grad`` over every
trainable parameter gives it (:607): AdamW then still decays it and
moves it by its momentum (BERT's pooler, an unused type embedding). The step count starts at 1, as at :1246-1248, and is
the ``t`` of the optimizer's bias corrections.

The step owns its dropout generator (a CPU ``torch.Generator`` seeded
from ``seed``): every dropout of the forward draws its seed words from
it, so a run repeats itself from the same seed and resumes exactly from
``state_dict()``, which holds the parameters, the optimizer's slots, the
step count and the generator's state. ``state_dict()`` is host
numpy, as the JAX package's is (bf16 widened to float32, the
generator's state as a ``uint8`` array); ``save(path)`` /
``load(path)`` write and read it through ``framework.save`` / ``load``,
so a run resumed in another process repeats the uninterrupted one bit
for bit.

Telemetry, as the JAX step wires it (docs/OBSERVABILITY.md):

- ``check_numerics`` (``False`` / ``True`` = ``"raise"`` / ``"warn"``)
  and ``skip_nonfinite_budget``: after ``backward()`` and BEFORE the
  optimizer's update the loss is read once (one sync a step) and the
  chaos site ``grad.nonfinite`` probed. A non-finite loss names its
  offender (the first non-finite gradient of this step, else parameter,
  by state-dict name) with JAX's messages, counts
  ``numerics_nonfinite_total``, and either skips the step (within the
  budget: the update is never applied, so the parameters, the slots and
  ``step_count`` stay as they were, with no copy; ``nonfinite_skips_total``
  and a ``nonfinite_skip`` flight event) or warns or raises
  :class:`~paddle_tpu_torch.monitor.NonFiniteError`;
- ``FLAGS_monitor``: ``train_step_*`` series, the measured memory peak
  and the cost of the first step (``cost_model.CostModel.attribute``,
  the kernel wrappers' own counts included) and the ``train_step_mfu``
  gauge; ``FLAGS_monitor`` or ``FLAGS_flight_recorder``: a flight
  record a step; ``FLAGS_trace``: one ``train.step`` trace a step;
- ``FLAGS_train_goodput``: the step is ``productive_dispatch``, a
  skipped one ``nonfinite_rollback``; ``FLAGS_train_health_every=N``:
  every Nth step copies the trainable parameters before its update and
  publishes per-layer grad norm, parameter norm and update ratio
  (``train_layer_*``), with the EWMA spike detector;
- ``FLAGS_monitor_port``: a ``/statusz`` section (:meth:`stats`).

With every flag off and no watchdog the step launches exactly what it
did without them: each seam is one flag read.

Data and tensor parallelism (the JAX ``mesh=``, ``data_spec=``,
``zero_axis=``; ``:367-400``): with a mesh (``fleet.init``'s
``hcg.mesh``, or the active one when ``data_spec`` or ``zero_axis`` is
given) the step cuts the model to this rank's blocks
(``spmd.apply_param_shardings``) and each call takes the GLOBAL batch,
as the JAX step does, and keeps this rank's rows by ``data_spec``
(``P("dp")``: the dp rank's ``B/dp`` rows); the dropouts then hash from
those rows' global index (``core.random.dropout_generator``'s batch
base), so every rank draws its slice of the single-process masks. After
the backward the gradients are averaged over the data axes (one
all-reduce of the flattened gradients an axis), the optimizer's clip
sums mp-sharded squares over mp, and ``zero_axis`` shards the
optimizer's slots (ZeRO-1: each rank updates its block of every
parameter, then one all-gather). The loss returned is the global
batch's: averaged over the data axes, with a criterion's masked mean
counting its mask over every data rank (``spmd.loss_average_groups``).
On a mesh with an ``sp`` axis of more than one rank (sequence
parallelism; the model must run sequence-parallel, as a GPT with
``GPTConfig.sequence_parallel`` does, else the step raises
``NotImplementedError``) every batch tensor of two or more dimensions
is cut on dimension 1 as well, each sp rank keeping its ``S/sp``
positions; the loss's count is summed over sp and so is the loss
returned, and the gradients are summed over the sp group before the
data-parallel mean.

Expert parallelism (the JAX step on an ``ep`` mesh, ``:493-520``): on a
mesh with an ``ep`` axis of ``n`` ranks (``data_spec=P("ep")`` cuts the
batch over it) ``apply_param_shardings`` leaves each rank its ``E/n``
experts of every ``P('ep', ...)`` leaf, and the MoE layers run the
expert-parallel program. Each rank's loss is the mean over its own rows
and the backward all-to-all brings every rank's cotangents home to an
expert, so an expert block's gradient sums the n ranks' means: it is
divided by n and never reduced (the blocks differ by rank), while every
other gradient is averaged over ep; the loss returned and a masked
mean's count are taken over ep as over a data axis, and the clip sums
the expert blocks' squares over ep. A step of a model whose stacked MoE
layers run over ep > 1 (``_ep_degree``) runs under the collective
watchdog as a ``moe_step`` of the ep group.

Gradient accumulation (``grad_accum_steps=k``, ``grad_accum_avg``, or
the ``gradient_merge`` of a strategy that
``fleet.distributed_optimizer`` attached to the optimizer): k-1 calls
only accumulate (``loss.backward()`` adds into ``.grad``; no
collective), the k-th accumulates, divides by k (``avg``, the default),
averages over the data axes and updates; ``step_count`` counts updates,
``stats()["microsteps"]`` calls (0 without accumulation, as in JAX). The
watchdog reads every call's loss; a skipped call, accumulating or
updating, undoes only itself, as the JAX step restores its accumulator:
the gradients go back to the window's sum before it, the counts back by
one, and the next call takes its place in the window.

``state_dict()`` / ``save`` / ``load`` gather every parameter and slot
to its full host array (a collective on every rank; rank 0 writes the
file) and cut them back on load, so the files are the single-process
step's. ``save_sharded`` / ``load_sharded`` are the sharded checkpoint
(``distributed.checkpoint``): each rank writes its own blocks, and a
load reshards into the step's layout.

Pipelines (the JAX step's pipeline detection, ``:477-516``): a model
carrying a ``PipelineStageStack`` on a pp axis of more than one rank
(or a ``PipelineParallel`` engine) runs each call under the collective
watchdog as a ``pipeline_step`` on the pp group, so a stage handoff that
hangs raises ``CollectiveTimeoutError``. The gradients of the
parameters the stages replicate (the embeddings, the final norm) are
summed over the pp group before the data-parallel mean, the clip sums
the pp-sharded blocks' squares over pp, and ZeRO-1's slot dimension
skips the pp dimension 0 of the stacked blocks (no mesh axis may
shard it twice). Either loss style runs: ``crit(layer(ids), labels)``
through the model's fill-drain forward, or ``layer.pretraining_loss
(...)`` under the resolved schedule.

``strategy.localsgd`` / ``adaptive_localsgd`` on the optimizer's fleet
snapshot make ``TrainStep(...)`` a ``distributed.fleet.meta_optimizers.
LocalSGDTrainStep`` (the JAX meta-optimizer dispatch, ``:319-364``).

Buffers (a vision model's BatchNorm ``_mean`` / ``_variance``) move in
the forward, in place: ``nn.functional.batch_norm`` writes them under
``no_grad``, as the JAX step threads them through its program. When the
watchdog is armed every call first copies them (they are small), and a
call that is undone, or whose update a raise drops, puts them back, as
the JAX step restores ``prev_buffers`` (:884-948). ``state_dict()``'s
``params`` hold them beside the parameters (``layer.state_dict()``).
Under ``FLAGS_jit_channels_last`` (read every call, default on) a model
with 2-D convolutions runs them channels-last: its 4-D conv weights and
the batch's 4-D float tensors take ``torch.channels_last`` memory format
(the JAX step's NHWC rewrite, :586-601; the logical shapes stay NCHW,
so the numbers do not depend on it). On a mesh whose data axes hold
more than one rank every batch norm of the model learns those axes'
groups (``_data_groups``) and takes its training statistics over the
global batch, as the JAX step under GSPMD does: one collective a layer
forward and one backward (``nn.functional_vision._batch_norm_global``);
its running statistics come out the same on every rank, so rank 0's
state dict is the model's. An optimizer
driven by an ``LRScheduler`` keeps its scheduler's rate across
``set_state_dict`` (its state rides in ``opt_state``).

Not ported: capturing the step in a CUDA graph.
"""

from __future__ import annotations

import contextlib
import time
import warnings
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.flags import get_flag
from ..core.tensor import unwrap
from ..core.random import dropout_generator
from ..nn.layout import to_channels_last
from ..distributed import env as dist_env
from ..distributed.spmd import loss_average_groups
from ..framework.io import load as fload
from ..framework.io import save as fsave
from ..framework.io import to_numpy
from ..monitor import flight_recorder as _flight
from ..monitor import goodput as _goodput
from ..monitor import trace as _trace
from ..monitor.metrics import get_registry
from ..testing import chaos

__all__ = ["TrainStep"]


def _layer_key(name: str) -> str:
    """Group a state-dict parameter name into its layer bucket: the
    prefix up to and including the first numeric path component
    (``layers.0.attn.qkv.weight`` -> ``layers.0``), else the first
    component (``embed.weight`` -> ``embed``); the JAX package's
    grouping."""
    parts = name.split(".")
    for i, p in enumerate(parts[:-1]):
        if p.isdigit():
            return ".".join(parts[:i + 1])
    return parts[0]


def _pipeline_group(layer: torch.nn.Module):
    """The pp group of a pipeline the model carries (a stack on a pp
    axis, or a ``PipelineParallel`` across stage processes), else None."""
    from ..distributed.meta_parallel.pipeline_parallel import \
        PipelineParallel
    from ..distributed.meta_parallel.spmd_pipeline import PipelineStageStack
    for m in layer.modules():
        if isinstance(m, PipelineStageStack) and m._pp_group is not None:
            return m._pp_group
        if isinstance(m, PipelineParallel) and m._handoff is not None:
            return m._handoff.group
    return None


def _ep_degree(layer: torch.nn.Module) -> int:
    """The ep degree the model's stacked MoE layers run at (the JAX
    step's ``_ep_degree``), 0 without one."""
    from ..incubate.moe import MoELayer
    return max((m._ep_degree() for m in layer.modules()
                if isinstance(m, MoELayer) and m._stacked), default=0)


class TrainStep:
    def __new__(cls, layer=None, loss_fn=None, optimizer=None, *args,
                **kwargs):
        # the fleet meta-optimizer dispatch: a strategy snapshot carried
        # by the optimizer selects the LocalSGD step (never the process's
        # strategy: a bare optimizer always gets the plain step)
        strat = getattr(optimizer, "_fleet_strategy", None)
        if cls is TrainStep and strat is not None and (
                strat.localsgd or strat.adaptive_localsgd):
            from ..distributed.fleet.meta_optimizers import \
                localsgd_from_strategy
            return localsgd_from_strategy(layer, loss_fn, optimizer, strat,
                                          args, kwargs)
        return super().__new__(cls)

    def __init__(self, layer: torch.nn.Module, loss_fn: Callable,
                 optimizer, seed: int = 0, *, mesh=None, data_spec=None,
                 zero_axis: Optional[str] = None,
                 grad_accum_steps: Optional[int] = None,
                 grad_accum_avg: Optional[bool] = None,
                 check_numerics=False, skip_nonfinite_budget: int = 0):
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(seed))
        self.device = next(iter(layer.parameters())).device
        self.step_count = 0
        if grad_accum_steps is None:
            # gradient merge comes only from the strategy snapshot that
            # fleet.distributed_optimizer attached to this optimizer
            grad_accum_steps = 1
            strat = getattr(optimizer, "_fleet_strategy", None)
            if strat is not None and strat.gradient_merge:
                cfg = strat.gradient_merge_configs
                grad_accum_steps = int(cfg["k_steps"])
                if grad_accum_avg is None:
                    grad_accum_avg = bool(cfg.get("avg", True))
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.grad_accum_avg = True if grad_accum_avg is None \
            else bool(grad_accum_avg)
        self._micro_count = 0
        self.mesh = mesh if mesh is not None else (
            dist_env.get_mesh() if data_spec is not None or zero_axis
            else None)
        self.data_spec = data_spec
        self.zero_axis = zero_axis
        self._batch_base = 0
        self._data_groups = []
        self._loss_groups = []
        self._sp_group = None
        self._ep_group = None
        self._ep_sharded = []
        self._pp_group = None
        self._pp_replicated = []
        from ..nn.layers.conv import Conv2D
        self._conv_weights = [m.weight for m in layer.modules()
                              if isinstance(m, Conv2D)]
        self._channels_last = None       # the conv weights' current format
        self._held_buffers = None
        if self.mesh is not None:
            self._lay_on_mesh()
        self._pp_group = _pipeline_group(layer)
        self._ep_degree = 0 if self._pp_group is not None else \
            _ep_degree(layer)
        optimizer.init_state()
        if check_numerics not in (False, True, "raise", "warn"):
            raise ValueError(f"check_numerics={check_numerics!r}: expected "
                             "False, True, 'raise' or 'warn'")
        self._check_numerics = check_numerics
        self.skip_nonfinite_budget = max(0, int(skip_nonfinite_budget))
        self._consecutive_skips = 0
        self._stats = {"nonfinite_trips": 0, "nonfinite_skips": 0,
                       "health_spikes": 0}
        self._health_mon = None
        #: per-kind attribution (the first step under FLAGS_monitor):
        #: flops / bytes_accessed / arithmetic_intensity / peak_bytes
        self._programs: Dict[str, dict] = {}
        self._wall_ema: Dict[str, float] = {}
        self._peak_flops_cache: Optional[float] = None
        if get_flag("flight_recorder"):
            _flight.get_flight_recorder().install()
        if get_flag("memory_preflight"):
            from ..monitor import memory as _memory
            _memory.preflight_check(_memory.known_bytes(train_step=self),
                                    device=self.device)
        if int(get_flag("monitor_port") or 0):
            from ..monitor import server as monitor_server
            srv = monitor_server.maybe_start_from_flags()
            if srv is not None:
                ref = weakref.ref(self)
                stale = monitor_server.STALE
                srv.register_status(
                    f"train_step-{id(self)}",
                    lambda: (lambda s: s.stats() if s is not None
                             else stale)(ref()))
                srv.register_status("goodput", _goodput.statusz_section)

    # -- the mesh ------------------------------------------------------------
    def _lay_on_mesh(self) -> None:
        """Cut the model to this rank's blocks, pick the data axes whose
        gradients are averaged, and lay the optimizer out (the mp
        group for its clip; ZeRO-1 over ``zero_axis``)."""
        from ..distributed.meta_parallel.parallel_layers.mp_layers import (
            mp_group_of)
        from ..distributed.spmd import (apply_param_shardings, data_axes,
                                        degrade_spec, P)
        from ..nn.layers.norm import _BatchNormBase
        mesh = self.mesh
        if dist_env.get_mesh() is None:
            dist_env.set_mesh(mesh)
        apply_param_shardings(self.layer, mesh)
        self._data_groups = [mesh.group(a) for a in data_axes(mesh)
                             if mesh.axis_size(a) > 1]
        for m in self.layer.modules():
            if isinstance(m, _BatchNormBase):
                m._data_groups = tuple(self._data_groups)
        self._loss_groups = list(self._data_groups)
        if mesh.axis_size("ep") > 1:
            # the ep ranks hold other rows (data_spec=P("ep")): the loss
            # is their mean, the expert blocks ep cut are theirs alone
            self._ep_group = mesh.group("ep")
            self._loss_groups.append(self._ep_group)
        if mesh.axis_size("sp") > 1:
            # only a layer that runs sequence-parallel (its sp group set
            # by _on_mesh) computes the global function on a shard
            if not any(getattr(m, "sp_group", None) is not None
                       for m in self.layer.modules()):
                raise NotImplementedError(
                    f"the mesh has an sp axis of {mesh.axis_size('sp')} "
                    f"ranks but no layer of {type(self.layer).__name__} "
                    "runs sequence-parallel: only a GPT with "
                    "GPTConfig.sequence_parallel does; leave sp_degree at "
                    "1 for this model")
            self._sp_group = mesh.group("sp")
        params = [p for p in self.layer.parameters() if p.requires_grad]
        mp_sharded = [p for p in params
                      if any("mp" in axes
                             for axes in p._dist_layout.values())]
        pp_sharded = [p for p in params
                      if any("pp" in axes
                             for axes in p._dist_layout.values())]
        self._ep_sharded = [p for p in params
                            if any("ep" in axes
                                   for axes in p._dist_layout.values())]
        pp_group = mesh.group("pp") if mesh.axis_size("pp") > 1 else None
        if pp_group is not None:
            self._pp_replicated = [p for p in params
                                   if not any(p is q for q in pp_sharded)]
        zero = {}
        if self.zero_axis and mesh.axis_size(self.zero_axis) > 1:
            z = mesh.axis_size(self.zero_axis)
            group = mesh.group(self.zero_axis)
            for p in params:
                spec = tuple(degrade_spec(getattr(p, "spec", None) or P(),
                                          mesh))
                spec += (None,) * (len(p._full_shape) - len(spec))
                # the JAX _slot_spec rule: the first dimension no mesh
                # axis names that the ZeRO axis divides
                for i, (s, d) in enumerate(zip(spec, p._full_shape)):
                    if s is None and d % z == 0 and d >= z:
                        zero[p] = (i, group)
                        break
        self.optimizer.set_distributed(mp_group_of(mesh), mp_sharded, zero,
                                       pp_group, pp_sharded, self._ep_group,
                                       self._ep_sharded)

    def _place(self, b) -> torch.Tensor:
        b = unwrap(b)
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        b = b.to(self.device)
        return to_channels_last(b) if self._channels_last else b

    @torch.no_grad()
    def _memory_format(self) -> None:
        """Lay the conv weights out as ``FLAGS_jit_channels_last`` says
        (once a change of the flag; a model without 2-D convolutions is
        left alone, and so are its inputs)."""
        cl = bool(get_flag("jit_channels_last")) and bool(
            self._conv_weights)
        if cl == self._channels_last:
            return
        fmt = torch.channels_last if cl else torch.contiguous_format
        for w in self._conv_weights:
            w.data = w.data.contiguous(memory_format=fmt)
        self._channels_last = cl

    def _hold_buffers(self, watch: bool) -> None:
        """Copy the layer's floating buffers before an armed call."""
        self._held_buffers = [(b, b.detach().clone())
                              for b in self.layer.buffers()
                              if b.is_floating_point()] if watch else None

    @torch.no_grad()
    def _restore_buffers(self) -> None:
        """Put back the buffers :meth:`_hold_buffers` copied."""
        for b, old in self._held_buffers or ():
            b.copy_(old)

    def _local_batch(self, b: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global batch tensor by ``data_spec``
        (the dropout batch base from its first dimension), and under
        sequence parallelism its sp rank's positions of dimension 1."""
        if self.mesh is None:
            return b
        from ..distributed.spmd import degrade_spec, mesh_slice
        if self.data_spec is not None:
            spec = tuple(degrade_spec(self.data_spec, self.mesh))
            for i, entry in enumerate(spec[:b.dim()]):
                start, size = mesh_slice(self.mesh, entry, b.shape[i])
                if i == 0:
                    self._batch_base = start
                b = b.narrow(i, start, size)
        if self._sp_group is not None and b.dim() >= 2:
            start, size = mesh_slice(self.mesh, "sp", b.shape[1])
            b = b.narrow(1, start, size)
        return b

    def _mean_over_data(self, t: torch.Tensor) -> torch.Tensor:
        from ..distributed.collective import ReduceOp, all_reduce
        for g in self._data_groups:
            all_reduce(t, ReduceOp.AVG, g)
        return t

    def _global_loss(self, t: torch.Tensor) -> torch.Tensor:
        """A rank's loss as the global batch's: summed over the sp
        shards, averaged over the data axes and ep."""
        from ..distributed.collective import ReduceOp, all_reduce
        if self._sp_group is not None:
            all_reduce(t, group=self._sp_group)
        for g in self._loss_groups:
            all_reduce(t, ReduceOp.AVG, g)
        return t

    @torch.no_grad()
    def _sync_grads(self) -> None:
        """The update's gradients: the window's sum divided by k
        (``grad_accum_avg``), the pp-replicated ones summed over the pp
        group; on an ep axis the expert blocks divided by its size and
        every other gradient averaged over it; then all averaged over
        each data axis; all the gradients of a dtype flattened into one
        all-reduce a group."""
        grads = [p.grad for p in self.layer.parameters()
                 if p.requires_grad and p.grad is not None]
        if self.grad_accum_steps > 1 and self.grad_accum_avg:
            torch._foreach_div_(grads, float(self.grad_accum_steps))
        if self._pp_replicated:
            from ..distributed.collective import all_reduce
            self._flat_reduce([p.grad for p in self._pp_replicated],
                              lambda t: all_reduce(t, group=self.mesh.group(
                                  "pp")))
        if self._sp_group is not None:
            # every parameter is replicated over sp: its shards' sum
            from ..distributed.collective import all_reduce
            self._flat_reduce(grads, lambda t: all_reduce(
                t, group=self._sp_group))
        if self._ep_group is not None:
            # each rank's loss is the mean over its own rows, and the
            # backward all-to-all brings every rank's cotangents home to
            # an expert: its gradient sums the n ranks' means, n times
            # the global mean's; it is this rank's alone, never reduced
            from ..distributed.collective import ReduceOp, all_reduce
            ep = {id(p) for p in self._ep_sharded}
            params = [p for p in self.layer.parameters()
                      if p.requires_grad and p.grad is not None]
            torch._foreach_div_([p.grad for p in params if id(p) in ep],
                                float(self._ep_group.nranks))
            self._flat_reduce(
                [p.grad for p in params if id(p) not in ep],
                lambda t: all_reduce(t, ReduceOp.AVG, self._ep_group))
        if self._data_groups:
            self._flat_reduce(grads, self._mean_over_data)

    @staticmethod
    def _flat_reduce(grads, reduce) -> None:
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        by_dtype: Dict[torch.dtype, list] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            flat = reduce(_flatten_dense_tensors(gs))
            for g, r in zip(gs, _unflatten_dense_tensors(flat, gs)):
                g.copy_(r)

    def __call__(self, *batch) -> torch.Tensor:
        """One step on ``batch``; returns the float32 loss on the device
        (reading it syncs)."""
        if not _trace.enabled():
            return self._dispatch(*batch)
        tr = _trace.get_tracer().start_trace("train.step",
                                             step=self.step_count + 1)
        # the wait for this step's batch happened before the trace
        # existed: attach it with its own timestamps
        led = _goodput.get_ledger()
        if led is not None and _goodput.active():
            dw = led.pop_pending_data_wait()
            if dw is not None:
                sp = tr.start_span("data_wait", t=dw[0])
                tr.end_span(sp, t=dw[1])
        try:
            with _trace.activate(tr):
                return self._dispatch(*batch)
        except BaseException as e:
            from ..monitor.numerics import NonFiniteError
            tr.mark_anomaly(
                "nonfinite" if isinstance(e, NonFiniteError)
                else "failed", error=f"{type(e).__name__}: {e}")
            raise
        finally:
            _trace.get_tracer().finish_trace(tr)

    def _dispatch(self, *batch) -> torch.Tensor:
        """A pipeline's step runs under the collective watchdog as a
        ``pipeline_step`` of its pp group, a step of expert-parallel MoE
        layers as a ``moe_step`` of the ep group (a direct call without
        ``FLAGS_collective_timeout_s``)."""
        from ..distributed.collective import _run_collective
        if self._pp_group is not None:
            return _run_collective("pipeline_step", self._pp_group,
                                   self._call_impl, *batch)
        if self._ep_degree > 1:
            from ..incubate.moe import moe_ep_group
            return _run_collective("moe_step", moe_ep_group(
                self._ep_degree), self._call_impl, *batch)
        return self._call_impl(*batch)

    @contextlib.contextmanager
    def _step_span(self, mon: bool):
        """RecordEvent around the step in monitor mode, and the
        ``dispatch`` span of an active step trace."""
        if not mon:
            with _trace.maybe_span("dispatch"):
                yield
            return
        from ..profiler import RecordEvent
        with RecordEvent("TrainStep.step"), _trace.maybe_span("dispatch"):
            yield

    def _attribution(self, first: bool):
        """The first step under FLAGS_monitor runs counted (cost_model)
        and its device-memory peak measured (monitor.memory)."""
        if not first:
            return contextlib.nullcontext(None)
        return _Attribution(self.device)

    def _call_impl(self, *batch) -> torch.Tensor:
        mon = bool(get_flag("monitor"))
        t_wall = time.perf_counter() if mon else 0.0
        fr = mon or bool(get_flag("flight_recorder"))
        watch = bool(self._check_numerics) or self.skip_nonfinite_budget > 0
        health_every = int(get_flag("train_health_every") or 0)
        self._memory_format()
        batch = [self._local_batch(self._place(b)) for b in batch]
        self._hold_buffers(watch)
        if self.grad_accum_steps > 1:
            self._micro_count += 1
            if self._micro_count % self.grad_accum_steps:
                return self._accumulate(batch, mon, fr, t_wall, watch)
        self.step_count += 1
        health = health_every > 0 and self.step_count % health_every == 0
        old = self._health_copy() if health else None
        t0 = time.perf_counter() if mon else 0.0
        bad, hvec = False, None
        with self._step_span(mon), _goodput.measure(
                "productive_dispatch", on_error="host_other"), \
                self._attribution(mon and "step" not in self._programs) \
                as attr:
            loss = self._forward(batch)
            held = self._backward(loss, watch)
            for p in self.layer.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._sync_grads()
            loss = self._global_loss(loss.detach().float())
            if chaos.active() and chaos.probe("grad.nonfinite"):
                loss = torch.full_like(loss, float("nan"))
            # the watchdog's one host read a step, before the update
            bad = watch and not bool(torch.isfinite(loss))
            if not bad:
                hvec = self._update(old)
        dispatch_s = time.perf_counter() - t0 if mon else None
        if attr is not None:
            self._programs["step"] = attr.entry
            if mon:
                self._publish_program("step", attr.entry)
        if mon:
            self._record_step_metrics(t_wall, dispatch_s)
        if fr:
            _flight.get_flight_recorder().record_step(
                self.step_count, loss=loss, kind="step",
                wall_ms=(time.perf_counter() - t_wall) * 1e3 if mon
                else None,
                dispatch_ms=None if dispatch_s is None
                else dispatch_s * 1e3)
        if bad:
            def rollback():
                # the update was never applied: the accumulator goes back
                # to what it held before this call, the step number with
                # it, and the buffers the forward moved
                self._restore_grads(held)
                self._restore_buffers()
                self.step_count -= 1
                if self.grad_accum_steps > 1:
                    self._micro_count -= 1
            if self._watchdog(loss, self.step_count, "step", rollback):
                # warn mode without a budget: the JAX step applied the
                # update whatever the loss read
                hvec = self._update(old)
        elif watch:
            self._consecutive_skips = 0
        if hvec is not None:
            self._publish_health(hvec, mon)
        return loss

    def _forward(self, batch) -> torch.Tensor:
        """``loss_fn`` on this rank's batch: its dropouts draw from the
        step's generator, and a masked mean counts its positions over
        the data axes (``spmd.loss_average_groups``)."""
        sums = [self._sp_group] if self._sp_group is not None else []
        with dropout_generator(self.generator, self._batch_base), \
                loss_average_groups(self._loss_groups, sums):
            return self.loss_fn(self.layer, *batch)

    def _backward(self, loss, watch: bool):
        """``loss.backward()``. Under the watchdog with accumulation the
        accumulator is set aside first and added back after (``new +
        old``, the bits of autograd's ``old + new``) and returned, so a
        skipped call can put it back (:meth:`_restore_grads`); else
        None."""
        if not (watch and self.grad_accum_steps > 1):
            loss.backward()
            return None
        params = [p for p in self.layer.parameters() if p.requires_grad]
        held = [p.grad for p in params]
        for p in params:
            p.grad = None
        loss.backward()
        with torch.no_grad():
            for p, h in zip(params, held):
                if h is None:
                    continue
                if p.grad is None:
                    p.grad = h.clone()
                else:
                    p.grad.add_(h)
        return list(zip(params, held))

    def _restore_grads(self, held) -> None:
        """Put back the gradients :meth:`_backward` set aside; without
        them (None) the call's gradients are dropped."""
        if held is None:
            self.optimizer.clear_grad()
            return
        for p, h in held:
            p.grad = h

    def _accumulate(self, batch, mon: bool, fr: bool, t_wall: float,
                    watch: bool):
        """An accumulate-only call: forward and backward into ``.grad``,
        no collective on the gradients. The watchdog reads its loss as
        the JAX step reads a microstep's."""
        with _goodput.measure("productive_dispatch", on_error="host_other"):
            loss = self._forward(batch)
            held = self._backward(loss, watch)
            loss = self._global_loss(loss.detach().float())
        if chaos.active() and chaos.probe("grad.nonfinite"):
            loss = torch.full_like(loss, float("nan"))
        if mon:
            self._record_step_metrics(t_wall, 0.0, kind="accum")
        if fr:
            _flight.get_flight_recorder().record_step(
                self._micro_count, loss=loss, kind="accum")
        if watch and not bool(torch.isfinite(loss)):
            def rollback():
                self._restore_grads(held)
                self._restore_buffers()
                self._micro_count -= 1
            self._watchdog(loss, self._micro_count, "microstep", rollback)
        elif watch:
            self._consecutive_skips = 0
        return loss

    def _update(self, old):
        """The optimizer's update and ``clear_grad``; on a health step
        the health vector (before the gradients go)."""
        self.optimizer.step(step=self.step_count)
        hvec = self._health(old) if old is not None else None
        self.optimizer.clear_grad()
        return hvec

    # -- the watchdog --------------------------------------------------------
    def _watchdog(self, loss, step_index: int, step_kind: str,
                  rollback) -> bool:
        """A non-finite loss, found before the update: nothing was
        applied. Within ``skip_nonfinite_budget`` consecutive skips the
        call is undone by ``rollback`` (the accumulator as it was before
        the call, ``step_count`` and the microstep count back) and the
        run goes on; past it the call is undone and the error raised.
        Without a budget ``"warn"`` warns and returns True (the caller
        applies the update, as the JAX step had), and ``"raise"`` drops
        the update, keeps the step number, and raises; an accumulating
        call is undone before it raises, so the window never divides a
        missing microbatch's share. ``step_kind`` is ``"step"`` (an
        update, ``step_index`` the step) or ``"microstep"`` (an
        accumulate-only call, the microstep), as in JAX."""
        led = _goodput.active_ledger()
        if led is None:
            return self._watchdog_trip(loss, step_index, step_kind,
                                       rollback)
        # a skipped step made no progress: its dispatch seconds move to
        # nonfinite_rollback, with the trip handling itself
        led.reattribute_last("nonfinite_rollback")
        with led.measure("nonfinite_rollback"):
            return self._watchdog_trip(loss, step_index, step_kind,
                                       rollback)

    def _named_grads(self) -> Dict[str, torch.Tensor]:
        return {k: p.grad for k, p in self.layer.named_parameters()
                if p.grad is not None}

    def _watchdog_trip(self, loss, step_index: int, step_kind: str,
                       rollback) -> bool:
        from ..monitor.numerics import NonFiniteError, first_nonfinite
        self._stats["nonfinite_trips"] += 1
        cur_trace = _trace.current_trace()
        if cur_trace is not None:
            cur_trace.mark_anomaly("nonfinite", step=step_index,
                                   step_kind=step_kind)
        bad_param = first_nonfinite(dict(self.layer.named_parameters()))
        bad_grad = first_nonfinite(self._named_grads())
        get_registry().counter(
            "numerics_nonfinite_total",
            "NaN/Inf watchdog trips by kind").inc(what="train_step")
        parts = [f"non-finite loss at {step_kind} {step_index}"]
        if bad_param is not None:
            parts.append(f"parameter {bad_param!r} was already non-finite "
                         "before this step")
        if bad_grad is not None:
            parts.append(f"first non-finite gradient: {bad_grad!r}")
        msg = ("; ".join(parts)
               + " (TrainStep check_numerics watchdog; the in-graph "
               "variant is FLAGS_check_nan_inf)")
        offender = bad_grad or bad_param or "loss"
        budget = self.skip_nonfinite_budget
        if budget:
            self._consecutive_skips += 1
            if self._consecutive_skips <= budget:
                rollback()
                self._stats["nonfinite_skips"] += 1
                get_registry().counter(
                    "nonfinite_skips_total",
                    "non-finite steps skipped under "
                    "skip_nonfinite_budget").inc()
                if _flight.enabled():
                    _flight.get_flight_recorder().record_event(
                        "nonfinite_skip", step=step_index,
                        step_kind=step_kind, offender=offender,
                        consecutive=self._consecutive_skips,
                        budget=budget)
                warnings.warn(
                    msg + f"; update skipped and rolled back "
                    f"({self._consecutive_skips}/{budget} consecutive)",
                    RuntimeWarning, stacklevel=4)
                return False
            rollback()
            msg += (f"; skip_nonfinite_budget exhausted "
                    f"({budget} consecutive non-finite steps; state "
                    "rolled back to the last finite step)")
        dump_path = _flight.trip_dump(step=step_index,
                                      reason="nan_watchdog",
                                      offender=offender,
                                      step_kind=step_kind)
        if dump_path:
            msg += f"; flight recorder dump: {dump_path}"
        if self._check_numerics == "warn" and not budget:
            warnings.warn(msg, RuntimeWarning, stacklevel=4)
            return True
        if not budget and step_kind == "microstep":
            rollback()
        elif not budget:
            self.optimizer.clear_grad()
            self._restore_buffers()
        raise NonFiniteError(msg, offender=offender, step=step_index)

    # -- per-layer health ----------------------------------------------------
    def _health_copy(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters before this step's update, copied
        in a few multi-tensor launches."""
        named = [(k, p.detach()) for k, p in self.layer.named_parameters()
                 if p.requires_grad]
        return dict(zip((k for k, _ in named),
                        torch._foreach_mul([p for _, p in named], 1.0)))

    @torch.no_grad()
    def _health(self, old: Dict[str, torch.Tensor]):
        """Per-layer f32 grad norm, post-update parameter norm and update
        ratio ``||new - old|| / (||old|| + eps)``: the layers and a
        ``[3, layers]`` tensor still on the device (read back in
        :meth:`_publish_health`). Multi-tensor norms, then one
        ``index_add`` a quantity; on an mp mesh the squares of the
        mp-sharded tensors are summed over the mp group and a replicated
        one counts once, so the norms are the unsharded model's."""
        names = list(old)
        params = dict(self.layer.named_parameters())
        cur = [params[k].detach() for k in names]
        prev = [old[k] for k in names]
        layers = sorted({_layer_key(k) for k in names})
        idx = torch.tensor([layers.index(_layer_key(k)) for k in names],
                           device=self.device)

        mp_group = self.optimizer._mp_group

        def per_layer(ts):
            sq = torch.stack(torch._foreach_norm(ts)).float().square()
            if mp_group is None:
                return torch.zeros(len(layers),
                                   device=self.device).index_add_(
                    0, idx, sq).sqrt()
            from ..distributed.collective import all_reduce
            sharded = torch.tensor(
                [id(params[k]) in self.optimizer._mp_sharded for k in names],
                device=self.device)
            acc = torch.zeros(2, len(layers), device=self.device)
            acc[0].index_add_(0, idx, torch.where(sharded, sq, 0.0))
            acc[1].index_add_(0, idx, torch.where(sharded, 0.0, sq))
            return (all_reduce(acc[0].clone(), group=mp_group)
                    + acc[1]).sqrt()

        grad = per_layer([params[k].grad for k in names])
        param = per_layer(cur)
        upd = per_layer(torch._foreach_sub(cur, prev))
        ratio = upd / (per_layer(prev) + 1e-12)
        return layers, torch.stack([grad, param, ratio])

    def _publish_health(self, hvec, mon: bool) -> None:
        """Read the health vector back (one copy), publish the
        ``train_layer_*`` gauges (monitor mode), run the spike detector,
        tail-mark the step trace and feed the flight recorder on a
        spike."""
        layers, vals = hvec
        grad, param, ratio = vals.cpu().tolist()
        host = {layer: {"grad_norm": grad[i], "param_norm": param[i],
                        "update_ratio": ratio[i]}
                for i, layer in enumerate(layers)}
        _goodput.note_layer_health(host, step=self.step_count)
        if self._health_mon is None:
            self._health_mon = _goodput.LayerHealthMonitor()
        spikes = self._health_mon.observe(host)
        if mon:
            reg = get_registry()
            g = reg.gauge("train_layer_grad_norm",
                          "per-layer gradient L2 norm (f32, every "
                          "FLAGS_train_health_every steps)")
            p = reg.gauge("train_layer_param_norm",
                          "per-layer post-update parameter L2 norm")
            u = reg.gauge("train_layer_update_ratio",
                          "per-layer ||update|| / ||param|| — the "
                          "classic learning-rate health signal")
            for layer, vals in host.items():
                g.set(vals["grad_norm"], layer=layer)
                p.set(vals["param_norm"], layer=layer)
                u.set(vals["update_ratio"], layer=layer)
        if spikes:
            self._stats["health_spikes"] += len(spikes)
            cur = _trace.current_trace()
            if cur is not None:
                cur.mark_anomaly("health_spike", step=self.step_count,
                                 layers=sorted(spikes))
            if mon:
                ctr = get_registry().counter(
                    "train_health_spikes_total",
                    "per-layer grad-norm EWMA spike detections")
                for layer in spikes:
                    ctr.inc(layer=layer)
            _flight.safe_record_event("health_spike", step=self.step_count,
                                      layers=sorted(spikes))

    # -- monitor mode ----------------------------------------------------------
    def _publish_program(self, kind: str, entry: dict) -> None:
        reg = get_registry()
        reg.gauge("train_step_program_flops",
                  "FLOPs per step by kind (cost_model count of the first "
                  "monitored step)").set(entry["flops"], kind=kind)
        reg.gauge("train_step_program_bytes_accessed",
                  "bytes accessed per step by kind (cost_model count)"
                  ).set(entry["bytes_accessed"], kind=kind)
        if entry.get("peak_bytes") is not None:
            reg.gauge("train_step_program_peak_hbm_bytes",
                      "device-memory peak of the first monitored step by "
                      "kind (monitor.memory)"
                      ).set(entry["peak_bytes"], kind=kind)

    def _peak_flops(self) -> float:
        if self._peak_flops_cache is None:
            from ..cost_model import device_peak_flops
            self._peak_flops_cache = (device_peak_flops()
                                      if self.device.type == "cuda"
                                      else None) or 0.0
        return self._peak_flops_cache

    def _record_step_metrics(self, t_wall: float, dispatch_s: float,
                             kind: str = "step") -> None:
        wall = time.perf_counter() - t_wall
        prev = self._wall_ema.get(kind)
        self._wall_ema[kind] = wall if prev is None \
            else 0.8 * prev + 0.2 * wall
        reg = get_registry()
        led = _goodput.active_ledger()
        if led is not None:
            led.publish(reg)
        reg.counter("train_step_steps_total",
                    "TrainStep calls by program kind").inc(kind=kind)
        reg.histogram("train_step_dispatch_seconds",
                      "time for the step's launches to return (the card "
                      "runs behind)").observe(dispatch_s, kind=kind)
        reg.histogram("train_step_wall_seconds",
                      "full TrainStep.__call__ wall time (host prep + "
                      "dispatch)").observe(wall, kind=kind)
        peak = self._peak_flops()
        flops = self._programs.get(kind, {}).get("flops")
        if peak and flops:
            reg.gauge("train_step_mfu",
                      "model FLOPs utilization by program kind (wall "
                      "EMA vs chip peak)").set(
                flops / (self._wall_ema[kind] * peak), kind=kind)

    def stats(self) -> dict:
        """Telemetry snapshot: the watchdog's counters, ``steps``, the
        per-kind attribution under ``programs`` (with an ``mfu`` where
        the card's peak is known and monitor mode has a wall EMA) and,
        with ``FLAGS_train_goodput``, the ledger. Plain-dict reads, no
        device sync."""
        d: Dict[str, Any] = dict(self._stats)
        peak = self._peak_flops()
        programs = {}
        for kind, entry in self._programs.items():
            e = {k: v for k, v in entry.items() if k != "kernels"}
            wall = self._wall_ema.get(kind)
            e["mfu"] = (e["flops"] / (wall * peak)
                        if peak and wall and e.get("flops") else None)
            programs[kind] = e
        d["programs"] = programs
        d["steps"] = self.step_count
        d["microsteps"] = self._micro_count
        d["grad_accum_steps"] = self.grad_accum_steps
        led = _goodput.get_ledger()
        if led is not None and _goodput.active():
            d["goodput"] = led.snapshot()
        return d

    # -- checkpoint/resume -------------------------------------------------
    def _slot_layouts(self) -> Dict[str, Any]:
        """``param{i}_slot{j}`` -> (its parameter, the ZeRO (dim, group)
        or None) on a mesh."""
        out = {}
        opt = self.optimizer
        for i, p in enumerate(opt._parameter_list):
            for j in range(len(opt._accumulators.get(id(p)) or ())):
                out[f"param{i}_slot{j}"] = (p, opt._zero.get(id(p)))
        return out

    def _gather_full(self, t, p, zero=None) -> torch.Tensor:
        """The full tensor of a rank's block: over the ZeRO axis
        (``zero``), then over the parameter's mesh axes."""
        from ..distributed.collective import all_gather
        from ..distributed.spmd import gather_tensor
        if zero is not None:
            dim, group = zero
            t = torch.cat(list(all_gather(t.contiguous(),
                                          group=group).unbind(0)), dim)
        return gather_tensor(t, getattr(p, "_dist_layout", {}), self.mesh)

    def _cut(self, full: torch.Tensor, p, zero=None) -> torch.Tensor:
        from ..distributed.spmd import cut_block
        return cut_block(full, getattr(p, "_dist_layout", {}), self.mesh,
                         zero)

    def state_dict(self) -> Dict[str, Any]:
        """Host numpy: the full parameters, slots, step count, the
        generator's state and lr. On a mesh every rank gathers (a
        collective) and every rank returns the same arrays."""
        params = self.layer.state_dict()
        opt = self.optimizer.state_dict()
        if self.mesh is not None:
            named = dict(self.layer.named_parameters())
            params = {k: self._gather_full(v, named[k]) if k in named
                      else v for k, v in params.items()}
            layouts = self._slot_layouts()
            opt = {k: self._gather_full(v.to(self.device), *layouts[k]).cpu()
                   if k in layouts else v for k, v in opt.items()}
        return {
            "params": {k: to_numpy(v) for k, v in params.items()},
            "opt_state": {k: to_numpy(v) if isinstance(v, torch.Tensor)
                          else v for k, v in opt.items()},
            "step_count": self.step_count,
            "rng_state": to_numpy(self.generator.get_state()),
            "lr": self.optimizer.get_lr(),
        }

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict`'s full arrays; on a mesh each rank
        keeps its blocks. A partial accumulation window is dropped."""
        def tensors(d):
            return {k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                    else v for k, v in d.items()}
        params, opt = tensors(state["params"]), tensors(state["opt_state"])
        if self.mesh is not None:
            named = dict(self.layer.named_parameters())
            params = {k: self._cut(v, named[k]) if k in named else v
                      for k, v in params.items()}
            layouts = self._slot_layouts()
            opt = {k: self._cut(v, *layouts[k]) if k in layouts else v
                   for k, v in opt.items()}
        self.optimizer.clear_grad()
        self._micro_count = 0
        self.layer.load_state_dict(params)
        self.optimizer.set_state_dict(opt)
        from ..optimizer.lr import LRScheduler
        if not isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer.set_lr(state["lr"])
        self.step_count = int(state["step_count"])
        self.generator.set_state(torch.as_tensor(state["rng_state"]))

    def save(self, path: str) -> None:
        """Write :meth:`state_dict` (on a mesh every rank gathers, rank 0
        writes)."""
        state = self.state_dict()
        if self.mesh is None or dist_env.get_rank() == 0:
            fsave(state, path)

    def load(self, path: str) -> None:
        self.set_state_dict(fload(path))

    def save_sharded(self, path: str, asynchronous: bool = True) -> None:
        """A sharded checkpoint of the step's state at ``path``
        (``distributed.checkpoint.save_train_step``: each rank writes the
        blocks it owns; on a mesh every rank calls it)."""
        from ..distributed.checkpoint import save_train_step
        save_train_step(self, path, asynchronous=asynchronous)

    def load_sharded(self, path: str) -> None:
        """Restore a checkpoint of :meth:`save_sharded` (or
        ``save_train_step``) resharded into this step's layout."""
        from ..distributed.checkpoint import load_train_step
        load_train_step(self, path)


class _Attribution:
    """The first monitored step: counted by ``cost_model.CostModel``'s
    modes and sinks, its device-memory peak measured. ``entry`` holds
    flops, bytes_accessed, arithmetic_intensity, the kernels' share and
    peak_bytes."""

    def __init__(self, device: torch.device):
        from ..monitor import memory as _memory
        self._mem = _memory.measure_program("step", device)
        self.entry: Dict[str, Any] = {}

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        from ..cost_model import _BytesMode
        from ..ops import kernels as K
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._mem)
        self._sink = self._stack.enter_context(K.cost_sink())
        self._fc = self._stack.enter_context(FlopCounterMode(display=False))
        self._bm = self._stack.enter_context(_BytesMode())
        return self

    def __exit__(self, *exc):
        out = self._stack.__exit__(*exc)
        if exc[0] is None:
            from ..cost_model import summarize
            self.entry = summarize(self._fc, self._bm, self._sink)
            pm = self._mem.result
            self.entry["peak_bytes"] = pm.peak_bytes if pm else None
        return out
