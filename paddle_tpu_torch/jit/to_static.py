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

Not ported: the mesh and its shardings, gradient accumulation, and
capturing the step in a CUDA graph.
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
from ..core.random import dropout_generator
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


class TrainStep:
    def __init__(self, layer: torch.nn.Module, loss_fn: Callable,
                 optimizer, seed: int = 0, *, check_numerics=False,
                 skip_nonfinite_budget: int = 0):
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(seed))
        self.device = next(layer.parameters()).device
        self.step_count = 0
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

    def _place(self, b) -> torch.Tensor:
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        return b.to(self.device)

    def __call__(self, *batch) -> torch.Tensor:
        """One step on ``batch``; returns the float32 loss on the device
        (reading it syncs)."""
        if not _trace.enabled():
            return self._call_impl(*batch)
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
                return self._call_impl(*batch)
        except BaseException as e:
            from ..monitor.numerics import NonFiniteError
            tr.mark_anomaly(
                "nonfinite" if isinstance(e, NonFiniteError)
                else "failed", error=f"{type(e).__name__}: {e}")
            raise
        finally:
            _trace.get_tracer().finish_trace(tr)

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
        batch = [self._place(b) for b in batch]
        self.step_count += 1
        health = health_every > 0 and self.step_count % health_every == 0
        old = self._health_copy() if health else None
        t0 = time.perf_counter() if mon else 0.0
        bad, hvec = False, None
        with self._step_span(mon), _goodput.measure(
                "productive_dispatch", on_error="host_other"), \
                self._attribution(mon and "step" not in self._programs) \
                as attr:
            with dropout_generator(self.generator):
                loss = self.loss_fn(self.layer, *batch)
            loss.backward()
            for p in self.layer.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss = loss.detach().float()
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
        if bad and self._watchdog(loss):
            # warn mode without a budget: the JAX step applied the
            # update whatever the loss read
            hvec = self._update(old)
        elif watch and not bad:
            self._consecutive_skips = 0
        if hvec is not None:
            self._publish_health(hvec, mon)
        return loss

    def _update(self, old):
        """The optimizer's update and ``clear_grad``; on a health step
        the health vector (before the gradients go)."""
        self.optimizer.step(step=self.step_count)
        hvec = self._health(old) if old is not None else None
        self.optimizer.clear_grad()
        return hvec

    # -- the watchdog --------------------------------------------------------
    def _watchdog(self, loss) -> bool:
        """A non-finite loss, found before the update: nothing was
        applied. Within ``skip_nonfinite_budget`` consecutive skips the
        step is dropped (gradients cleared, ``step_count`` back) and the
        run goes on; past it the step is dropped and the error raised.
        Without a budget ``"warn"`` warns and returns True (the caller
        applies the update, as the JAX step had), and ``"raise"`` drops
        the update, keeps the step number, and raises."""
        led = _goodput.active_ledger()
        if led is None:
            return self._watchdog_trip(loss)
        # a skipped step made no progress: its dispatch seconds move to
        # nonfinite_rollback, with the trip handling itself
        led.reattribute_last("nonfinite_rollback")
        with led.measure("nonfinite_rollback"):
            return self._watchdog_trip(loss)

    def _named_grads(self) -> Dict[str, torch.Tensor]:
        return {k: p.grad for k, p in self.layer.named_parameters()
                if p.grad is not None}

    def _watchdog_trip(self, loss) -> bool:
        from ..monitor.numerics import NonFiniteError, first_nonfinite
        step_index = self.step_count
        self._stats["nonfinite_trips"] += 1
        cur_trace = _trace.current_trace()
        if cur_trace is not None:
            cur_trace.mark_anomaly("nonfinite", step=step_index,
                                   step_kind="step")
        bad_param = first_nonfinite(dict(self.layer.named_parameters()))
        bad_grad = first_nonfinite(self._named_grads())
        get_registry().counter(
            "numerics_nonfinite_total",
            "NaN/Inf watchdog trips by kind").inc(what="train_step")
        parts = [f"non-finite loss at step {step_index}"]
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

        def rollback():
            # the update was never applied: drop the gradients and the
            # step number; parameters and slots are as they were
            self.optimizer.clear_grad()
            self.step_count -= 1

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
                        step_kind="step", offender=offender,
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
                                      offender=offender, step_kind="step")
        if dump_path:
            msg += f"; flight recorder dump: {dump_path}"
        if self._check_numerics == "warn" and not budget:
            warnings.warn(msg, RuntimeWarning, stacklevel=4)
            return True
        self.optimizer.clear_grad()
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
        ``index_add`` a quantity."""
        names = list(old)
        params = dict(self.layer.named_parameters())
        cur = [params[k].detach() for k in names]
        prev = [old[k] for k in names]
        layers = sorted({_layer_key(k) for k in names})
        idx = torch.tensor([layers.index(_layer_key(k)) for k in names],
                           device=self.device)

        def per_layer(ts):
            sq = torch.stack(torch._foreach_norm(ts)).float().square()
            return torch.zeros(len(layers), device=self.device).index_add_(
                0, idx, sq).sqrt()

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
        led = _goodput.get_ledger()
        if led is not None and _goodput.active():
            d["goodput"] = led.snapshot()
        return d

    # -- checkpoint/resume -------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": {k: to_numpy(v)
                       for k, v in self.layer.state_dict().items()},
            "opt_state": {k: to_numpy(v) if isinstance(v, torch.Tensor)
                          else v
                          for k, v in self.optimizer.state_dict().items()},
            "step_count": self.step_count,
            "rng_state": to_numpy(self.generator.get_state()),
            "lr": self.optimizer.get_lr(),
        }

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        def tensors(d):
            return {k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                    else v for k, v in d.items()}
        self.layer.load_state_dict(tensors(state["params"]))
        self.optimizer.set_state_dict(tensors(state["opt_state"]))
        self.optimizer.set_lr(state["lr"])
        self.step_count = int(state["step_count"])
        self.generator.set_state(torch.as_tensor(state["rng_state"]))

    def save(self, path: str) -> None:
        fsave(self.state_dict(), path)

    def load(self, path: str) -> None:
        self.set_state_dict(fload(path))


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
