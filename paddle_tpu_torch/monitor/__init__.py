"""paddle_tpu_torch.monitor — the port's telemetry plane.

Port of ``paddle_tpu/monitor/`` (docs/OBSERVABILITY.md), with the JAX
package's metric names, flags and zero-overhead contracts:

1. a structured **metrics registry** (:mod:`.metrics`): thread-safe
   Counter/Gauge/Histogram with labels, Prometheus text + JSONL export,
   a process-global default registry plus :func:`scoped_registry`;
2. **step-time instrumentation** in ``jit.TrainStep`` (``stats()``; the
   ``train_step_*`` series under ``FLAGS_monitor``) and the serving
   engine's always-on ``serve_*`` series;
3. the **NaN/Inf watchdog** (:mod:`.numerics`): one host read for a
   whole dict of tensors; ``TrainStep(check_numerics=...,
   skip_nonfinite_budget=...)`` names the first offending gradient and
   skips a non-finite update before it is applied;
4. **device memory accounting** (:mod:`.memory`) on the CUDA caching
   allocator: measured per-kind peaks, the ``FLAGS_memory_preflight``
   check, a live-buffer census and :class:`LeakMonitor`;
5. the **crash flight recorder** (:mod:`.flight_recorder`);
6. **structured tracing** (:mod:`.trace`) and **SLO burn**
   (:mod:`.slo`);
7. the **admin server** (:mod:`.server`, ``FLAGS_monitor_port``) and the
   **timeseries ring** (:mod:`.timeseries`);
8. the **goodput ledger** and per-layer **model health**
   (:mod:`.goodput`, ``FLAGS_train_goodput``,
   ``FLAGS_train_health_every``).

9. the **fleet federator** (:mod:`.fleet`, ``FLAGS_fleet_monitor_*``):
   the replicas' and the router's pages in one host-labelled fleet
   registry, the merged fleet trace (:func:`~.fleet.merge_fleet_traces`
   joins the router's ``fleet.request`` tree with each replica's
   ``serve.request`` tree under one trace_id), fleet SLO burn and
   incident bundles.

The registry is always importable and writable; the HOT paths only write
to it when ``FLAGS_monitor`` is set (the serving engine's request
metrics excepted, as in the JAX package), pinned by the write_count
guard in tests/test_torch_monitor.py; the flight recorder has the same
contract via ``FLAGS_flight_recorder`` and its ``record_count`` probe.
"""

from . import (fleet, flight_recorder, goodput, memory,  # noqa: F401
               slo, timeseries, trace)
from .fleet import FleetFederator, merge_fleet_traces  # noqa: F401
from .goodput import GoodputLedger, LayerHealthMonitor  # noqa: F401
from .flight_recorder import (FlightRecorder,  # noqa: F401
                              get_flight_recorder, set_flight_recorder)
from .memory import (LeakMonitor, MemoryBudgetError,  # noqa: F401
                     ProgramMemory, live_buffer_census, memory_summary,
                     preflight_check)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      get_registry, lint_exposition, load_jsonl,
                      load_registry_jsonl, scoped_registry)
from .timeseries import TimeseriesRing  # noqa: F401
from .numerics import (NaNWatchdog, NonFiniteError, all_finite,  # noqa: F401
                       check_numerics, first_nonfinite, nonfinite_entries)
from .slo import SLOTracker  # noqa: F401
from .trace import (Span, Trace, Tracer, export_perfetto,  # noqa: F401
                    get_tracer, set_tracer, start_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "scoped_registry", "load_jsonl", "load_registry_jsonl",
    "lint_exposition", "TimeseriesRing",
    "NaNWatchdog", "NonFiniteError", "all_finite", "check_numerics",
    "first_nonfinite", "nonfinite_entries",
    "ProgramMemory", "MemoryBudgetError", "LeakMonitor",
    "live_buffer_census", "memory_summary", "preflight_check",
    "FlightRecorder", "get_flight_recorder", "set_flight_recorder",
    "enabled",
    "Span", "Trace", "Tracer", "get_tracer", "set_tracer",
    "start_trace", "export_perfetto", "SLOTracker",
    "GoodputLedger", "LayerHealthMonitor",
    "FleetFederator", "merge_fleet_traces",
]


def enabled() -> bool:
    """True when ``FLAGS_monitor`` is set — hot paths consult this before
    writing per-step samples into the registry."""
    from ..core.flags import get_flag
    return bool(get_flag("monitor"))
