"""Global configuration flags (the subset the port reads).

Counterpart of ``paddle_tpu/core/flags.py``: one registry, each value
read from the environment (``FLAGS_<name>``) unless :func:`set_flags`
or :func:`flag_scope` set it. The port defines only the flags whose
behaviour it has (``serve_kv_quant``, ``amp_int8_matmul``, the
serving throughput features ``serve_prefix_cache``,
``serve_prefill_chunk``, ``serve_spec_k``, ``serve_spec_ngram``, the
serving watchdog ``serve_watchdog_s``, ``checkpoint_verify`` and the
model lifecycle's ``serve_hot_swap``, ``serve_traffic_split`` and
``serve_lifecycle``, the vision path's ``jit_channels_last``, and
the MoE layer's ``moe_dispatch``, ``moe_expert_parallel`` and
``moe_a2a_chunks``, and recsys's ``recsys_dedup`` and
``recsys_sharded_lookup``); it has no
kernel kill switches (the JAX package's
``pallas_*`` flags), because a kernel wrapper on the card launches its
kernel or raises. The monitor flags (``monitor``, ``trace``,
``flight_recorder``, ``chaos``, ``monitor_port``, ``train_goodput``,
``train_health_every``, the fleet federator's ``fleet_monitor_*`` and
their companions) keep the JAX package's names and defaults.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags", "flag_scope"]


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    parser: Callable[[str], Any]
    value: Any = None
    explicitly_set: bool = False


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default: Any, help: str = "") -> None:
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    _REGISTRY[name] = _Flag(name, default, help, parser)


def _flag(name: str) -> _Flag:
    flag = _REGISTRY.get(name)
    if flag is None:
        raise KeyError(f"Unknown flag: {name!r}")
    return flag


def get_flag(name: str) -> Any:
    flag = _flag(name)
    if flag.explicitly_set:
        return flag.value
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        return flag.parser(env)
    return flag.default


def get_flags(names) -> Dict[str, Any]:
    """``paddle.get_flags``: ``{name: value}`` for a name or a list."""
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    """``paddle.set_flags`` analogue."""
    for name, value in flags.items():
        flag = _flag(name)
        flag.value = value
        flag.explicitly_set = True


@contextlib.contextmanager
def flag_scope(name: str, value: Any):
    """Override a flag for a with-block, restoring both the previous
    value and whether it was set explicitly (so a ``FLAGS_*`` variable
    is not shadowed afterwards)."""
    flag = _flag(name)
    saved = (flag.value, flag.explicitly_set)
    flag.value = value
    flag.explicitly_set = True
    try:
        yield
    finally:
        flag.value, flag.explicitly_set = saved


define_flag("serve_kv_quant", "",
            "Quantized paged KV cache (serving.kv_cache): 'int8' stores "
            "the K/V page pools as int8 with a per-(position, head) f32 "
            "absmax scale pool beside them; decode reads them through "
            "the quantized paged-decode kernel. Empty (default) = the "
            "full-precision pools. Read once at cache construction.")
define_flag("jit_channels_last", True,
            "Run a model's 2-D convolutions channels-last inside "
            "jit.TrainStep: the 4-D conv weights and 4-D float batch "
            "inputs take torch.channels_last memory format (the layout "
            "cuDNN's fast bf16 path wants). The tensors keep their "
            "logical NCHW shape, so results do not depend on the flag. "
            "Read at every step.")
define_flag("moe_dispatch", "sort",
            "MoE token dispatch/combine implementation "
            "(incubate.moe): 'sort' (default) = argsort by expert, one "
            "scatter into the [E*C + 1, D] buffer and one gather back, "
            "O(T*k*D) data moved; 'einsum' = the GShard one-hot "
            "dispatch/combine einsums over O(T*E*C) tensors, the parity "
            "oracle. Both paths share one router, so capacity clipping "
            "and drop decisions are identical.")
define_flag("moe_expert_parallel", True,
            "Run stacked-expert MoE layers on a mesh with an 'ep' axis "
            "of more than one rank through the explicit expert-parallel "
            "program: each rank routes its own tokens at the local "
            "capacity and exchanges capacity chunks with its ep peers "
            "by all-to-all. The port has no other path on such a mesh: "
            "off, the layer raises NotImplementedError (reason "
            "'flag_off').")
define_flag("moe_a2a_chunks", 2,
            "Capacity-dim chunks of the expert-parallel all-to-all: "
            "every chunk's tokens-out exchange is issued before any "
            "expert computes, each chunk's tokens-back exchange right "
            "after that chunk's FFN. Reduced until a chunk's width "
            "tiles the local capacity. 1 = no chunking.")
define_flag("recsys_dedup", True,
            "Unique/dedup embedding lookups in recsys: sort-unique the "
            "batch ids, gather each distinct row once, inverse-permute "
            "back. Sparse gradients accumulate over the unique set before "
            "the row update either way (the SparseTable push semantics); "
            "off = the per-id gather, the parity oracle (same rows, "
            "O(batch) instead of O(unique) row traffic).")
define_flag("recsys_sharded_lookup", True,
            "Run ShardedEmbeddingTable lookups and updates on a ps > 1 "
            "mesh through the explicit program: each ps rank gathers the "
            "unique rows it owns and one all_reduce over the ps group "
            "assembles the batch. Off selects the JAX package's GSPMD "
            "auto path, which has no counterpart when ranks are "
            "processes: the port raises NotImplementedError there.")
define_flag("amp_int8_matmul", False,
            "EXPERIMENTAL: under an active amp.auto_cast region, run "
            "nn.functional.linear matmuls whose 2-D weight tiles (K and N "
            "multiples of 128) through the int8 kernel "
            "(ops.kernels.quant_matmul.int8_amp_linear): dynamic "
            "per-tensor activation and per-channel weight quantization, "
            "a straight-through dense backward. Off by default; read at "
            "every call.")
define_flag("checkpoint_verify", "manifest",
            "Checkpoint validation level for distributed.checkpoint "
            "restores and latest_step scans. 'manifest' (default) = a "
            "committed manifest must exist and every file it lists must "
            "be present with the recorded size (catches uncommitted and "
            "torn directories); 'full' = additionally re-checksum every "
            "file against the manifest CRCs (catches silent bit "
            "corruption, costs one read of the checkpoint); 'off' = "
            "existence check only (restores legacy pre-manifest "
            "checkpoints). CRCs are RECORDED at commit time only under "
            "'full' (they cost a full re-read of the staged tree); "
            "manifests without CRCs still verify at 'manifest' level.")
define_flag("collective_timeout_s", 0.0,
            "Watchdog timeout (seconds) for the collectives of "
            "distributed.collective: a call that does not return within "
            "the budget raises CollectiveTimeoutError (with a "
            "collective_timeout flight-recorder event) instead of "
            "hanging the rank forever. 0 (default) = no watchdog, "
            "direct call. The budget covers the whole call, including a "
            "group's first (communicator set-up); set it well above "
            "that.")
define_flag("pipeline_schedule", "",
            "Global pipeline-schedule override for PipelineStageStack: "
            "'1f1b' (one forward, one backward) or 'fill_drain' (every "
            "forward, then every backward). Empty = resolve from the "
            "model, then the fleet strategy "
            "(pipeline_configs['schedule_mode']).")
define_flag("serve_watchdog_s", 0.0,
            "Wall-clock watchdog (seconds) for serving prefill/decode "
            "dispatches (serving.engine): a dispatch that "
            "does not return within the budget raises "
            "DecodeWatchdogError (with a decode_watchdog flight event "
            "and dump) instead of stalling the serving loop forever. "
            "0 (default) = no watchdog, direct dispatch — zero "
            "overhead. The budget covers a whole dispatch including a "
            "cold compile; warmup() first, or set it well above "
            "cold-start time. Modeled on FLAGS_collective_timeout_s.")
define_flag("serve_prefix_cache", False,
            "Radix-tree prefix cache over the serving KV page pools "
            "(serving.prefix_cache): completed/evicted requests donate "
            "their full pages into a token-keyed radix tree with per-page "
            "refcounts; admission walks the tree and maps shared pages "
            "copy-on-write into the new slot's block table, so chat "
            "traffic with shared system prompts skips the redundant "
            "prefix prefill. Off (default) = every admission prefills "
            "from token 0. Read at ServingEngine construction.")
define_flag("serve_prefill_chunk", 0,
            "Chunked prefill (serving.engine): > 0 = long prompts prefill "
            "in chunks of at most this many tokens, one chunk per engine "
            "iteration interleaved with the decode dispatches, so a long "
            "admission no longer stalls running decodes for its whole "
            "prompt. Later chunks attend over the pages earlier chunks "
            "wrote (the context-prefill path). 0 (default) = one-shot "
            "prefill. Read at ServingEngine construction.")
define_flag("serve_spec_k", 0,
            "Speculative decoding draft length (serving.spec_decode): > 0 "
            "= an n-gram/prompt-lookup drafter (no second model) proposes "
            "up to k tokens per slot and ONE batched verify dispatch "
            "scores all k+1 positions against the paged cache; the "
            "accepted prefix plus one bonus token commit, rejected tails "
            "roll back by block-table truncation. Greedy output is "
            "token-identical to the non-speculative path; sampled slots "
            "run stochastic residual accept/reject, distribution-"
            "identical to plain sampled decode. 0 (default) = one decode "
            "dispatch per token. Read at ServingEngine construction.")
define_flag("serve_spec_ngram", 3,
            "Longest suffix n-gram the speculative drafter matches "
            "against the request's own prompt+generated history "
            "(prompt-lookup decoding); it backs off to shorter n-grams "
            "down to 1 before giving up on a slot for the iteration.")
define_flag("serve_hot_swap", False,
            "Live weight hot-swap (serving.engine): arm "
            "ServingEngine.swap_weights — load and verify a candidate "
            "checkpoint, stage the new parameter dict beside the live "
            "one and cut over at the next iteration boundary, slots in "
            "flight finishing on the weights they started on (a "
            "per-slot weights epoch; drain-and-resubmit when the card "
            "cannot hold two trees). Off (default) = swap_weights "
            "raises and the engine dispatches exactly as without it. "
            "Read once at engine construction.")
define_flag("serve_traffic_split", False,
            "Shadow/A-B traffic splitting (serving.router): arm "
            "FleetRouter.set_traffic_split — a TrafficSplit hash-splits "
            "a fraction of requests onto a candidate replica (A/B) "
            "and/or mirrors a fraction as shadow copies (responses "
            "discarded, fully measured), with per-arm counters, "
            "latency histograms and greedy-divergence counters. Off "
            "(default) = set_traffic_split raises and no new series. "
            "Read once at router construction.")
define_flag("serve_lifecycle", False,
            "SLO-guarded promotion controller (serving.lifecycle): arm "
            "LifecycleController — stage a candidate checkpoint on one "
            "replica, bake it under a traffic split while an SLOTracker "
            "watches the candidate arm, then promote (a rolling swap, "
            "one replica at a time) or roll back, with flight events "
            "and an incident bundle on rollback. Off (default) = the "
            "controller refuses to construct. Read once at controller "
            "construction.")

# -- the monitor plane (paddle_tpu_torch.monitor, .testing.chaos) -----------
define_flag("monitor", False,
            "Stream hot-path telemetry into the paddle_tpu_torch.monitor metrics "
            "registry: per-step TrainStep wall/dispatch timings, compile/"
            "recompile counters. "
            "Off (default) = ZERO per-step registry writes on the train "
            "step hot path (tests pin this). Eager collective tracing is "
            "the check_numerics watchdog is its own TrainStep argument "
            "and is not gated by this flag; the serving engine's "
            "request metrics are always on.")
define_flag("memory_preflight", "",
            "OOM pre-flight check: when a TrainStep is built, compare the "
            "bytes known before the first step (parameters, gradients, "
            "optimizer slots; monitor.memory) against the card's free "
            "memory (torch.cuda.mem_get_info) BEFORE step 1 runs. '' (default) = off; "
            "'warn' = RuntimeWarning when the estimate exceeds the "
            "budget; 'raise' = MemoryBudgetError. No-op when the budget "
            "is unknown (CPU test backend) and no explicit limit is set.")
define_flag("memory_preflight_limit_mb", 0,
            "Explicit device-memory budget (MiB) for the pre-flight check; "
            "0 = ask the card (torch.cuda.mem_get_info). Set it to a "
            "target card's memory to answer 'will this config fit?' "
            "from any machine.")
define_flag("flight_recorder", False,
            "Record every TrainStep into the crash flight recorder ring "
            "buffer even with FLAGS_monitor off, and install the "
            "unhandled-exception + faulthandler dump hooks at the first "
            "TrainStep construction. (FLAGS_monitor on also records "
            "steps; this flag adds the hooks and keeps recording when "
            "the registry stream is off.)")
define_flag("flight_recorder_dir", "",
            "Directory for flight-recorder dump files "
            "(flight_recorder_*.json); empty = current directory.")
define_flag("flight_recorder_capacity", 256,
            "Ring-buffer size of the flight recorder: how many recent "
            "step records survive to a crash dump.")
define_flag("chaos", "",
            "Deterministic fault-injection spec for "
            "paddle_tpu_torch.testing.chaos (tests, chip_smoke.py): "
            "comma-separated 'site[@N|:prob][*times]' entries, e.g. "
            "'ckpt.write.torn@2,collective.hang:0.1'. Empty (default) = "
            "no injection, zero probe overhead.")
define_flag("chaos_seed", 0,
            "Seed for probability-based chaos sites: the same "
            "(seed, site, occurrence) triple always makes the same "
            "fire/no-fire decision, so chaos runs replay exactly.")
define_flag("trace", False,
            "Structured request/step tracing (monitor/trace.py): span "
            "trees with trace ids through the serving request lifecycle "
            "and the training step. Off (default) = zero span "
            "allocations and zero trace registry writes — the same "
            "zero-overhead contract as FLAGS_monitor, pinned by test.")
define_flag("trace_sample", 0.01,
            "Head sampling rate for structured traces (fraction of "
            "traces retained at random). Tail-based sampling keeps any "
            "trace containing an expired/shed/failed/watchdog/chaos/"
            "nonfinite event REGARDLESS of this rate, so anomalies "
            "always ship a full span tree.")
define_flag("trace_ring", 64,
            "Capacity of the retained-trace ring (flight-recorder "
            "model: newest N traces survive to a dump/export).")
define_flag("monitor_port", 0,
            "TCP port for the embedded admin/telemetry HTTP server "
            "(paddle_tpu_torch.monitor.server): GET /metrics (Prometheus "
            "text with exemplars), /healthz, /readyz (503 while the "
            "serving engine is draining/shedding/watchdog-tripped), "
            "/statusz (fingerprint, flags, program table, occupancy, "
            "rates, SLO burn), /debug/flight, /debug/trace "
            "(?format=perfetto) and /debug/profile?seconds=N (arms a "
            "live profiler window, returns the chrome trace). Started "
            "by the serving engine and (opt-in) TrainStep when set; "
            "-1 = an ephemeral OS-assigned port (tests). 0 (default) "
            "= OFF: no thread, no socket, no registry writes — the "
            "zero-overhead contract, pinned by test.")
define_flag("monitor_host", "127.0.0.1",
            "Bind address for the admin server. Loopback by default — "
            "the plane exposes flags, program tables and profiles, so "
            "exposing it beyond the host is an explicit operator "
            "decision (front it with real auth if you must).")
define_flag("fleet_monitor_port", 0,
            "TCP port for the fleet federator's admin plane "
            "(paddle_tpu_torch.monitor.fleet): a scrape loop pulls every "
            "configured replica /metrics page into ONE host-labelled "
            "fleet registry and serves its own /metrics, /statusz "
            "(per-replica table), /healthz and /readyz (quorum of "
            "replica readiness). -1 = an ephemeral OS-assigned port. 0 "
            "(default) = OFF: no scrape thread, no socket, no registry "
            "series.")
define_flag("fleet_monitor_targets", "",
            "Comma-separated scrape targets for the fleet federator, "
            "each 'name=http://host:port' (/metrics is implied; /readyz "
            "and /debug/* derive from the same base). Empty (default) = "
            "federate the local process registry under the host label "
            "'fleet' (an in-process fleet, whose router and replicas "
            "share one registry).")
define_flag("fleet_monitor_interval_s", 1.0,
            "Fleet federator scrape period in seconds.")
define_flag("fleet_monitor_slo", 0.0,
            "Fleet availability SLO objective as a fraction (e.g. "
            "0.999) over the federated serve_requests_total deltas "
            "(good = completed; bad = expired/failed/shed/rejected). 0 "
            "(default) = no fleet SLO tracker.")
define_flag("fleet_monitor_incident_dir", "",
            "Directory for the fleet federator's incident bundles (on a "
            "fleet SLO burn alert or a tail-retained anomaly trace: the "
            "implicated replica's flight-recorder doc, the merged "
            "Perfetto trace, the fleet statusz and the federated "
            "metrics page, rate-limited). Empty (default) = no capture.")
define_flag("train_goodput", False,
            "Training goodput ledger (monitor/goodput.py): attribute "
            "every second of trainer wall-clock to one exclusive "
            "bucket (productive_dispatch / compile / data_wait / "
            "checkpoint_stall / nonfinite_rollback / restart_gap / "
            "host_other) and publish "
            "train_goodput_pct + train_badput_seconds_total{bucket} "
            "under FLAGS_monitor. Off (default) = one flag read per "
            "seam, no ledger allocation, no registry series — the "
            "zero-overhead contract.")
define_flag("train_health_every", 0,
            "Per-layer model-health telemetry cadence: N > 0 computes "
            "f32 per-layer grad-norm / param-norm / update-ratio "
            "on every Nth optimizer step (the update ratio from a copy "
            "of the parameters taken before that step's update) and "
            "publishes train_layer_* gauges, with an EWMA spike detector that "
            "tail-marks the step trace (reason 'health_spike') and "
            "attaches the last vector to flight-recorder dumps. "
            "0 (default) = OFF: the step launches exactly what it did and "
            "nothing is computed or published.")
