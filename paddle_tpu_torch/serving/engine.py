"""LLM serving engine: paged decode + continuous batching, PyTorch port.

Counterpart of ``paddle_tpu/serving/engine.py``. Each
:meth:`ServingEngine.step`:

0. honours a latched drain signal (``enable_drain``: the engine drains
   and raises ``EngineDrained``), cuts over to staged weights (see
   below), expires queued requests past their
   deadline, cancels or expires in-flight ones (``cancel``,
   ``Request.deadline_s``) and feeds the overload detector;
1. admits waiting requests into free slots (``Scheduler``), mapping the
   longest cached prefix copy-on-write when the prefix cache is on;
2. prefills every prefilling slot's next chunk in bucketed groups, each
   group one forward of ``[batch_bucket, len_bucket]`` token ids over
   the paged pools (padded rows writing only to the scratch page), and
   samples the first token of each request whose prefill is done;
3. stages speculative drafts (``serve_spec_k``), makes room for every
   decoding slot's next positions (recompute-preempting the newest
   requests when the pool runs dry) and runs ONE decode, or verify,
   forward over the full slot batch (other slots masked), one per
   weights epoch while a hot swap is in transition.

The JAX engine compiled one program per signature, donating the KV
pools to each; the port runs the same forwards eagerly and writes the
pools in place. On the card a fresh prefill's attention launches the
flash kernel, a context prefill's (a chunk continuation or a prefix-hit
tail, at ``pos > 0``) and a verify window's the biased flash kernel with
``causal=1`` over the right-aligned gathered context, and a decode
step the paged-decode kernel.

Throughput features, each behind its flag and read once, at
construction (``flag_scope`` around the constructor): the radix prefix
cache (``serve_prefix_cache``), chunked prefill
(``serve_prefill_chunk``) and n-gram speculative decoding
(``serve_spec_k``, ``serve_spec_ngram``). With all three off an engine
makes exactly the dispatches it made without them.

``ServingConfig.cache_dtype`` is ``"float32"`` or ``"bfloat16"``; a
bf16 engine (``inference.create_serving_engine`` under
``enable_tpu_bf16``) serves bf16 parameters over bf16, float32 or int8
pools, as the JAX engine does: the KV scatter casts k and v to the
pools' dtype, and the model casts q to it at the kernels and the
output back. Float32 parameters over bf16 pools are refused.

Multi-tenant serving: an engine built under ``flag_scope(
"serve_kv_quant", "int8")`` keeps int8 pools and decodes through the
quantized paged-decode kernel; ``ServingConfig.lora_adapters > 0``
builds a :class:`~.lora.LoRAManager` whose pools and per-row adapter ids
ride every prefill and decode view (the bgmv kernel, once per layer per
dispatch); ``tenant_quota`` caps the slots one tenant holds.

Resilience, as in the JAX engine, each off by default: bounded-queue
shedding by ``ServingConfig.queue_policy``; the queue-delay overload
detector (``overload_threshold_s``), which sheds every submit while it
is tripped; graceful drain (``enable_drain`` / ``drain``), which stops
admission, decodes in-flight requests for ``drain_budget_s`` and
commits the rest as a snapshot a successor engine resumes
(``resilience.requests_from_snapshot``); the dispatch watchdog
(``FLAGS_serve_watchdog_s``), which runs every prefill, context, verify
and decode dispatch on one worker thread and turns one that outlives
its budget into ``DecodeWatchdogError``; ``/readyz`` reports
``drained``, ``draining``, ``shedding`` and ``watchdog-tripped``. With
every knob at its default an engine writes no new registry series and
launches what it launched without them.

Observability, as in the JAX engine ("an engine exists to be
observed"): the ``serve_*`` request, latency, dispatch and gauge series
are always on (``monitor.get_registry()``); under ``FLAGS_trace`` each
request is one trace (queued, admitted, prefill, decode[i] / verify[i],
detok spans; failures tail-retained); terminal events other than
completion land in the flight recorder as ``request_*`` events;
``ServingConfig.slo_availability`` arms an availability burn tracker;
``FLAGS_monitor_port`` registers ``/readyz`` and ``/statusz`` on the
admin plane. Chaos: ``serve.request.poison`` marks a request at submit,
whose logits rows turn NaN ahead of the finiteness checks, so it fails
alone; ``serve.detok.raise`` raises in a token's callback. Not ported:
the ``serve_program_*`` series (the port compiles no programs).

Tensor-parallel serving (``ServingConfig.mesh``, a
``distributed.spmd.Mesh`` with an ``mp`` axis): every rank of the mp
group runs an engine over the same traffic. The engine lays the model
out on the mesh before it snapshots the parameters (the Megatron specs:
``H/mp`` heads, ``FF/mp`` of the MLP, ``V/mp`` rows of the tied table),
builds its pools at the rank's heads (``spmd.SERVE_KV_SPEC``, int8
scale pools too) and a LoRA ``b`` pool at the rank's QKV columns, and
gathers the logits' vocab blocks over mp where it samples. A head count
that mp does not divide raises ``ValueError`` at construction. The
ranks keep in lockstep through mp rank 0's decisions
(:mod:`.lockstep`): admissions, preemptions, ends, the overload state,
the drain and the sampled tokens are the leader's. On an mp group the
dispatch watchdog is refused (each forward's collectives run under
``FLAGS_collective_timeout_s``), and so is a live weight swap.

Live weight hot-swap (``FLAGS_serve_hot_swap``, read once at
construction), as in the JAX engine: :meth:`ServingEngine.swap_weights`
verifies a committed checkpoint of this engine's parameter dict
(``distributed.checkpoint``, never below ``manifest``), refuses a torn
or mismatched one with :class:`WeightSwapError` and no side effect, and
stages the rest. The staged dict becomes the live one at the next
iteration boundary (at once when nothing is in flight); every residency
is stamped with the weights epoch whose tree wrote its first K/V and
finishes on that tree, so a transition dispatches once per epoch, and
the radix prefix cache is flushed (its pages hold the old weights' K/V).
When the card cannot hold a second tree the swap drains the slots into
snapshot specs, cuts over and resubmits the continuations.
``rollback_weights`` re-stages the retained tree; ``commit_swap`` drops
it. With the flag off an engine dispatches exactly as without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..core.device import DeviceLike, resolve_device
from ..core.flags import get_flag
from ..core.random import make_generator
from ..monitor import enabled as _monitor_enabled
from ..monitor import flight_recorder as _flight
from ..monitor import get_registry
from ..monitor import memory as _memory
from ..monitor import trace as _trace
from ..monitor.slo import SLOTracker
from ..testing import chaos
from .detok import StreamingDetokenizer
from .kv_cache import (PagedCacheView, PagedKVCache, blocks_needed,
                       context_index)
from .lockstep import Lockstep
from .lora import LoRAManager
from .prefix_cache import RadixPrefixCache
from .resilience import (DecodeWatchdogError, DispatchWorker, DrainLatch,
                         DrainReport, EngineDrained, OverloadDetector,
                         ServerOverloaded, request_spec,
                         requests_from_snapshot, save_drain_snapshot)
from .sampling import SamplingParams, sample_tokens, verify_draws
from .scheduler import (QUEUE_POLICIES, AdmissionGroup, BucketTable,
                        Request, RequestState, Scheduler)
from .spec_decode import propose_ngram

__all__ = ["ServingConfig", "ServingEngine", "WeightSwapError"]


class WeightSwapError(RuntimeError):
    """A candidate weight push was refused (torn manifest, parameter
    mismatch, unreadable checkpoint) or a rollback had nothing retained
    to roll back to. A refusal has no side effect: the serving weights
    did not change and traffic keeps flowing on them."""

    def __init__(self, manifest_dir: str, reason: str):
        super().__init__(
            f"weight swap refused for {manifest_dir!r}: {reason}")
        self.manifest_dir = manifest_dir
        self.reason = reason

#: live engines, for test isolation (``serving.reset`` shuts them down)
_LIVE_ENGINES: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()

#: the launch gate of the guarded dispatch running on this thread (the
#: watchdog's worker), read by ``ServingEngine._forward``
_LAUNCH = threading.local()


class _DispatchAbandoned(RuntimeError):
    """A guarded dispatch reached its first launch after the watchdog
    abandoned it; it stops there."""


class _LaunchGate:
    """Whether a guarded dispatch has started launching, decided under a
    lock against its abandonment: the job passes the gate before its
    first launch, and once the caller has abandoned it the gate raises
    instead, so an abandoned job that had not started never will."""

    def __init__(self):
        self._lock = threading.Lock()
        self._started = False
        self._abandoned = False

    def enter(self) -> None:
        with self._lock:
            if self._abandoned:
                raise _DispatchAbandoned("dispatch abandoned by the "
                                         "watchdog before its first launch")
            self._started = True

    def abandon(self) -> bool:
        """Abandon the job; returns whether it had started launching."""
        with self._lock:
            self._abandoned = True
            return self._started


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


#: the pool dtypes the paged-decode and flash kernels take
_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ServingConfig:
    """Engine sizing + policy.

    ``max_context_len`` bounds prompt+generation per request;
    ``num_pages`` sizes the shared KV pool (default: every slot fully
    resident, so no preemption — shrink it to trade memory for
    recompute-preemptions). ``prefill_buckets``/``batch_buckets`` are the
    prefill shapes. ``cache_dtype`` is the pools' dtype, ``"float32"``
    or ``"bfloat16"`` (``FLAGS_serve_kv_quant=int8`` overrides it with
    int8 pools). ``lora_adapters > 0`` builds a LoRA manager with that
    many loadable adapters of rank ``lora_rank``; ``tenant_quota`` caps
    the slots one tenant may hold at a time (None: no cap).
    ``queue_policy`` sheds a full queue (``reject-new``, ``drop-oldest``
    or ``priority``); ``overload_threshold_s > 0`` arms the queue-delay
    EWMA detector (``overload_alpha``, exit at ``overload_exit_frac`` of
    the threshold), which sheds every submit while tripped.
    ``slo_availability`` / ``slo_deadline`` in (0, 1) arm the
    multi-window error-budget burn trackers over request outcomes and
    completion slack (``slo_windows`` seconds); 0.0 (default) = no
    tracker. ``drain_budget_s`` is how long a drain keeps decoding
    in-flight requests before it snapshots the rest into ``drain_dir``
    (None: a drain with pending work refuses). ``mesh`` (a
    ``distributed.spmd.Mesh``) serves tensor-parallel over its ``mp``
    axis, each rank of the group running an engine in lockstep with mp
    rank 0; None (default) is the one-process engine."""

    max_batch_slots: int = 8
    block_size: int = 16
    max_context_len: int = 512
    num_pages: Optional[int] = None
    prefill_buckets: Optional[Tuple[int, ...]] = None
    batch_buckets: Tuple[int, ...] = (1, 2, 4)
    max_queue: int = 1024
    seed: int = 0
    cache_dtype: str = "float32"
    detokenizer: Optional[StreamingDetokenizer] = None
    lora_adapters: int = 0
    lora_rank: int = 8
    tenant_quota: Optional[int] = None
    queue_policy: str = "reject-new"
    overload_threshold_s: float = 0.0
    overload_alpha: float = 0.3
    overload_exit_frac: float = 0.5
    slo_availability: float = 0.0
    slo_deadline: float = 0.0
    slo_windows: Tuple[float, ...] = (60.0, 300.0, 3600.0)
    drain_budget_s: float = 5.0
    drain_dir: Optional[str] = None
    mesh: Optional[object] = None

    def resolve(self, model_max_positions: Optional[int]) -> None:
        if self.queue_policy not in QUEUE_POLICIES:
            raise ValueError(
                f"unknown queue_policy {self.queue_policy!r}; one of "
                f"{QUEUE_POLICIES}")
        if self.cache_dtype not in _CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype={self.cache_dtype!r}: the port's pools are "
                f"one of {sorted(_CACHE_DTYPES)}")
        if model_max_positions is not None:
            self.max_context_len = min(self.max_context_len,
                                       int(model_max_positions))
        if self.prefill_buckets is None:
            lo = min(max(self.block_size, 16), self.max_context_len)
            self.prefill_buckets = _pow2_buckets(lo, self.max_context_len)
        else:
            self.prefill_buckets = tuple(
                min(int(b), self.max_context_len)
                for b in self.prefill_buckets)
            if max(self.prefill_buckets) < self.max_context_len:
                # preemption re-prefills prompt+generated-so-far; the
                # table must cover the worst case
                self.prefill_buckets += (self.max_context_len,)
        self.batch_buckets = tuple(
            min(int(b), self.max_batch_slots) for b in self.batch_buckets)
        if self.num_pages is None:
            per_slot = blocks_needed(self.max_context_len, self.block_size)
            self.num_pages = 1 + self.max_batch_slots * per_slot


def _check_dtypes(params: Dict[str, torch.Tensor], cache_dtype: str):
    """Refuse a float32 parameter copy over bfloat16 pools. The model
    casts a bf16 copy's q to the pools' dtype at the decode kernels,
    exactly, and the output back (``GPTAttention._paged_attention``);
    but the bf16 decode kernel would round a float32 q to bf16, where
    the JAX kernel lifts q and the pages to f32, so the tokens would
    not be the JAX engine's."""
    if get_flag("serve_kv_quant") or cache_dtype != "bfloat16":
        return
    wide = {p.dtype for p in params.values() if p.is_floating_point()
            and torch.finfo(p.dtype).bits > 16}
    if wide:
        raise ValueError(
            f"parameters in {sorted(map(str, wide))} over "
            f"cache_dtype={cache_dtype!r} pools: the bf16 decode kernel "
            "would round q to bf16 (serve bf16 pools with "
            "param_dtype=torch.bfloat16, or keep cache_dtype='float32')")


class ServingEngine:
    """Serve a decoder-only model — ``forward(input_ids,
    caches=<PagedCacheView>, cache_pos=<[B] int32 positions>)`` returning
    logits ``[B, S, V]`` — with continuous batching on ``device`` (the
    card unless ``device="cpu"`` is passed)."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device: DeviceLike = None, clock=time.perf_counter, *,
                 param_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        # full-float32 products on the card, as the JAX package's
        # "highest" matmul precision (this is PyTorch's default; set
        # explicitly so a caller's global setting cannot change tokens)
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = getattr(model, "cfg", None)
        if cfg is None:
            raise ValueError("ServingEngine needs a model with a .cfg "
                             "(num_heads/head_dim/num_layers)")
        self.model = model.to(self.device).eval()
        self.mesh = config.mesh if config is not None else None
        #: the mp group of a tensor-parallel engine (None: one process)
        self._mp_group = None
        self._lockstep: Optional[Lockstep] = None
        if self.mesh is not None:
            self._lay_on_mesh(cfg)
        # the weights served: a detached copy of the parameters and
        # buffers taken now, as the JAX engine's param_arrays /
        # buffer_arrays are (paddle_tpu/serving/engine.py:224-225), so a
        # layer that goes on training does not change this engine;
        # ``param_dtype`` casts the floating parameters as they are
        # copied (the layer keeps its own)
        self.params = {
            k: p.detach().to(dtype=param_dtype if param_dtype is not None
                             and p.is_floating_point() else p.dtype,
                             copy=True)
            for k, p in self.model.named_parameters()}
        self.buffers = {k: b.detach().clone()
                        for k, b in self.model.named_buffers()}
        # resolve() fills model-dependent defaults on a copy, so a
        # caller-owned config can be reused across engines
        self.config = dataclasses.replace(config) if config is not None \
            else ServingConfig()
        self.config.resolve(getattr(cfg, "max_position_embeddings", None))
        self.clock = clock
        c = self.config
        _check_dtypes(self.params, c.cache_dtype)
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.head_dim,
            num_pages=c.num_pages, block_size=c.block_size,
            max_slots=c.max_batch_slots,
            max_blocks_per_slot=blocks_needed(c.max_context_len,
                                              c.block_size),
            dtype=_CACHE_DTYPES[c.cache_dtype], device=self.device,
            mesh=self.mesh)
        self.buckets = BucketTable(c.prefill_buckets, c.batch_buckets)
        self.lora = None
        if c.lora_adapters > 0:
            # built before the scheduler, which keeps its references
            self.lora = LoRAManager(
                cfg.num_layers, cfg.hidden_size,
                3 * cfg.num_heads * cfg.head_dim,
                max_adapters=c.lora_adapters, rank=c.lora_rank,
                device=self.device, head_block=self.cache.head_block)
        self.scheduler = Scheduler(self.cache, self.buckets,
                                   max_queue=c.max_queue, clock=clock,
                                   max_seq_len=c.max_context_len,
                                   policy=c.queue_policy,
                                   on_event=self._on_request_event,
                                   tenant_quota=c.tenant_quota,
                                   lora=self.lora,
                                   follower=self._lockstep is not None
                                   and not self._lockstep.leader)
        self._overload = (OverloadDetector(
            c.overload_threshold_s, alpha=c.overload_alpha,
            exit_frac=c.overload_exit_frac)
            if c.overload_threshold_s > 0 else None)
        self._slo_avail = (SLOTracker(
            "serve_availability", c.slo_availability,
            windows=c.slo_windows, clock=clock)
            if c.slo_availability > 0 else None)
        self._slo_deadline = (SLOTracker(
            "serve_deadline", c.slo_deadline,
            windows=c.slo_windows, clock=clock)
            if c.slo_deadline > 0 else None)
        self._drain_latch: Optional[DrainLatch] = None
        self._draining = False
        self._drained = False
        self._watchdog_threads: List[threading.Thread] = []
        self._watchdog_worker: Optional[DispatchWorker] = None
        #: the last watchdog trip; /readyz reports it until a later
        #: guarded dispatch returns
        self._watchdog_tripped: Optional[dict] = None
        #: serving dispatches so far (prefill, verify, decode)
        self._dispatch_seq = 0
        # the throughput features, each read once here so an engine's
        # behaviour is fixed for its lifetime
        self._chunk = int(get_flag("serve_prefill_chunk") or 0)
        self._spec_k = int(get_flag("serve_spec_k") or 0)
        self._spec_ngram = max(1, int(get_flag("serve_spec_ngram") or 1))
        self.prefix_cache = None
        if bool(get_flag("serve_prefix_cache")):
            self.prefix_cache = RadixPrefixCache(self.cache)
            self.cache.prefix_cache = self.prefix_cache
        self._generator = make_generator(c.seed, self.device)
        # the accept/reject coin of stochastic speculative sampling: a
        # host stream of its own (the JAX engine's seed formula), apart
        # from the generator the sampled tokens draw from
        self._spec_rng = np.random.default_rng((int(c.seed) << 1) ^ 0x51EC)
        self._stats = {"prefill_dispatches": 0, "decode_dispatches": 0,
                       "decode_slot_steps": 0, "decode_batch_max": 0,
                       "tokens_generated": 0, "prefill_tokens": 0,
                       "prefill_chunks": 0, "context_prefill_dispatches": 0,
                       "verify_dispatches": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "spec_rolled_back": 0}
        self._lat: Dict[str, List[float]] = {
            "ttft": [], "tpot": [], "e2e": [], "decode_step": []}
        self._t_first_work: Optional[float] = None
        self._t_last_token: Optional[float] = None
        #: delta-publish cursors: host stats are the source of truth,
        #: the registry sees monotone deltas
        self._prefix_published: Dict[str, float] = {}
        self._quota_published: Dict[str, int] = {}
        #: the kinds whose first dispatch's device-memory peak is
        #: recorded under FLAGS_monitor (monitor.memory.ProgramMemory)
        self._measured_kinds: set = set()
        # live weight hot-swap, read once: off, swap_weights raises,
        # _retired stays empty and every dispatch takes the one-epoch path
        self._hot_swap = bool(get_flag("serve_hot_swap"))
        #: live weights generation, bumped at every cutover (rollbacks
        #: included); a residency finishes on its stamped epoch's tree
        self._weights_epoch = 0
        #: candidate staged for the next iteration-boundary cutover
        self._staged: Optional[dict] = None
        #: epoch -> parameter dict still referenced by in-flight slots
        self._retired: Dict[int, dict] = {}
        #: the pre-swap tree, kept as the rollback anchor until
        #: commit_swap() drops it or rollback_weights() re-stages it
        self._previous: Optional[dict] = None
        self._live_manifest: Optional[str] = None
        self._swap_stats = {"staged": 0, "cutover": 0, "refused": 0,
                            "rolled_back": 0, "committed": 0,
                            "drain_swaps": 0}
        if get_flag("memory_preflight"):
            _memory.preflight_check(_memory.known_bytes(engine=self),
                                    device=self.device)
        _LIVE_ENGINES.add(self)
        self._attach_admin()

    def _lay_on_mesh(self, cfg) -> None:
        """Cut the model to this rank's blocks (the JAX engine's
        ``apply_hybrid_specs`` + ``apply_param_shardings``) and join the
        mp group's lockstep. Raises ``ValueError`` when mp does not
        divide the heads."""
        from ..distributed.mp_ops import mp_group_of
        from ..distributed.spmd import (apply_hybrid_specs,
                                        apply_param_shardings)
        mp = self.mesh.axis_size("mp")
        if cfg.num_heads % mp:
            raise ValueError(
                f"model num_heads={cfg.num_heads} not divisible by mesh "
                f"mp={mp}; TP serving shards KV over heads")
        apply_hybrid_specs(self.model)
        apply_param_shardings(self.model, self.mesh)
        self._mp_group = mp_group_of(self.mesh)
        if self._mp_group is not None:
            self._lockstep = Lockstep(self._mp_group)

    def _full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits from the rank's block (an
        all-gather over mp; ``logits`` itself on one process)."""
        if self._mp_group is None:
            return logits
        from ..distributed.mp_ops import gather_from_model_parallel
        return gather_from_model_parallel(logits, self._mp_group)

    @torch.no_grad()
    def warmup(self) -> int:
        """Build every kernel library (on the card), then run one
        forward of each dispatch signature this engine can issue before
        traffic arrives: the decode batch, every ``(batch, length)``
        prefill bucket and, with chunking or the prefix cache on, its
        context twin, and with ``serve_spec_k`` the verify window.
        Every row is padding (an all-scratch table row, the zero
        adapter), so only the scratch page is written and no engine
        counter moves (the kernels' launch counts do). Returns the
        number of kernels loaded (0 on the CPU)."""
        n_kernels = 0
        if self.device.type == "cuda":
            from ..ops import kernels
            kernels.build()
            n_kernels = len(kernels.KERNELS)
        B = self.config.max_batch_slots
        sigs = [(B, 1, False)]
        for nb, sp in self.buckets.signatures():
            sigs.append((nb, sp, False))
            if self._chunk > 0 or self.prefix_cache is not None:
                sigs.append((nb, sp, True))
        if self._spec_k > 0:
            sigs.append((B, self._spec_k + 1, True))
        for nb, sp, ctx in sigs:
            self._forward(np.zeros((nb, sp), np.int64), [None] * nb,
                          np.zeros((nb,), np.int32), context=ctx)
        return n_kernels

    # -- admin plane (monitor/server.py) --------------------------------------
    def _attach_admin(self) -> None:
        """Join the admin plane when ``FLAGS_monitor_port`` is set:
        ``/readyz`` reads this engine's state and ``/statusz`` gains its
        section. The providers hold a weakref: a collected engine returns
        the STALE sentinel and the server prunes it. Flag unset = one
        flag read, no thread, no socket."""
        from ..monitor import server as monitor_server
        self._admin = monitor_server.maybe_start_from_flags()
        self._admin_key = f"serving_engine_{id(self)}"
        if self._admin is None:
            return
        ref = weakref.ref(self)
        stale = monitor_server.STALE
        self._admin.register_readiness(
            self._admin_key,
            lambda: (lambda e: stale if e is None else e._readiness())(
                ref()))
        self._admin.register_status(
            self._admin_key,
            lambda: (lambda e: stale if e is None
                     else e._admin_status())(ref()))

    def _readiness(self) -> Optional[dict]:
        """None while this engine should receive traffic; otherwise a
        JSON reason from the serving state machine, the load balancer's
        signal to pull this replica. Reads live state only, so a
        transition shows within the iteration it happens."""
        if self._drained:
            return {"state": "drained",
                    "detail": "engine drained; hand traffic to the "
                              "successor"}
        if self._draining or (self._drain_latch is not None
                              and self._drain_latch.triggered):
            return {"state": "draining",
                    "queue_depth": self.scheduler.queue_depth,
                    "active_slots": len(self.scheduler.active())}
        if self._overload is not None and self._overload.overloaded:
            return {"state": "shedding",
                    "ewma_s": round(self._overload.ewma_s, 4),
                    "threshold_s": self._overload.threshold_s,
                    "queue_depth": self.scheduler.queue_depth}
        if self._watchdog_tripped is not None:
            return dict(self._watchdog_tripped, state="watchdog-tripped")
        return None

    def _admin_status(self) -> dict:
        """/statusz section: occupancy, outcome stats, SLO burn."""
        d: dict = {
            "scheduler": dict(self.scheduler.stats,
                              queue_depth=self.scheduler.queue_depth,
                              active_slots=len(self.scheduler.active())),
            "kv_pages_in_use": self.cache.allocator.pages_in_use,
            "kv_pages_total": self.cache.allocator.num_pages,
            "engine_stats": dict(self._stats),
            "draining": self._draining,
            "drained": self._drained,
            "overloaded": (self._overload.overloaded
                           if self._overload is not None else False),
            "watchdog_tripped": self._watchdog_tripped,
        }
        if self._hot_swap:
            d["weights"] = {
                "epoch": self._weights_epoch,
                "live_manifest": self._live_manifest,
                "staged": (self._staged["manifest"]
                           if self._staged is not None else None),
                "retired_epochs": sorted(self._retired),
                "rollback_available": self._previous is not None,
                "swaps": dict(self._swap_stats),
            }
        if self.lora is not None:
            d["lora"] = self.stats()["lora"]
        if self.scheduler.tenant_quota is not None:
            d["tenant_deferrals"] = dict(self.scheduler.tenant_deferrals)
        if self._slo_avail is not None:
            d["slo_availability"] = self._slo_avail.snapshot()
        if self._slo_deadline is not None:
            d["slo_deadline"] = self._slo_deadline.snapshot()
        return d

    def _detach_admin(self) -> None:
        admin = getattr(self, "_admin", None)
        if admin is not None:
            admin.unregister_readiness(self._admin_key)
            admin.unregister_status(self._admin_key)
            self._admin = None

    # -- request lifecycle telemetry -----------------------------------------
    #: deadline-slack buckets: negative = finished past the deadline
    DEADLINE_SLACK_BUCKETS = (-1.0, -0.1, 0.0, 0.05, 0.1, 0.25, 0.5,
                              1.0, 2.0, 5.0, 30.0)

    @staticmethod
    def _requests_counter():
        return get_registry().counter(
            "serve_requests_total",
            "serving requests by lifecycle event")

    def _on_request_event(self, outcome: str, st: RequestState) -> None:
        """Scheduler terminal-transition hook: metrics, flight event, SLO
        and span-tree closure. Fires on lifecycle events only."""
        if self._lockstep is not None:
            self._lockstep.record(st.request.request_id, outcome)
        self._requests_counter().inc(event=outcome)
        if st.request.tenant:
            get_registry().counter(
                "serve_tenant_requests_total",
                "serving requests by tenant and lifecycle event").inc(
                tenant=st.request.tenant, event=outcome)
        if outcome != "completed":
            _flight.safe_record_event(
                "request_failed" if outcome == "failed"
                else f"request_{outcome}",
                request_id=st.request.request_id,
                reason=st.failure, tokens=len(st.generated),
                preemptions=st.preemptions)
        if self._slo_avail is not None:
            # cancelled and drained are the client's and the operator's
            # choices: they spend no budget
            if outcome == "completed":
                self._slo_avail.record(good=1)
            elif outcome in ("expired", "failed", "shed"):
                self._slo_avail.record(bad=1)
            self._slo_avail.publish()
        if self._slo_deadline is not None and outcome == "expired":
            # a blown deadline, queued or in flight (completions are fed
            # from _accept_token)
            self._slo_deadline.record(bad=1)
            self._slo_deadline.publish()
        self._close_trace(st, outcome)

    def _close_trace(self, st: RequestState, outcome: str) -> None:
        """Terminal span and retention decision of a traced request."""
        tr = st.trace
        if tr is None:
            return
        now = self.clock()
        for key in ("queued", "admitted"):
            sp = st.trace_spans.pop(key, None)
            if sp is not None:
                tr.end_span(sp, t=now)
        tr.event("terminal", t=now, outcome=outcome,
                 reason=st.failure, tokens=len(st.generated),
                 preemptions=st.preemptions)
        if outcome in ("expired", "shed", "failed"):
            reason = st.failure or ""
            tr.mark_anomaly(
                "nonfinite" if "non-finite" in reason
                else ("chaos" if st.poisoned
                      else ("failed" if outcome == "failed"
                            else outcome)),
                failure=st.failure)
        tr.root.set_attrs(outcome=outcome)
        _trace.get_tracer().finish_trace(tr, t=now)
        st.trace_spans.clear()

    def _trace_requeue(self, st: RequestState, reason: str) -> None:
        """A request that lost its slot (recompute-preemption, watchdog
        rollback) keeps its trace: the admitted span closes and a new
        queued one opens."""
        tr = st.trace
        if tr is None:
            return
        now = self.clock()
        spn = st.trace_spans.pop("admitted", None)
        if spn is not None:
            tr.end_span(spn, t=now, requeued=reason)
        old_q = st.trace_spans.pop("queued", None)
        if old_q is not None:
            tr.end_span(old_q, t=now, requeued=reason)
        st.trace_spans["queued"] = tr.start_span(
            "queued", t=now, reason=reason, preemptions=st.preemptions)

    # -- request surface ----------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        if self._draining or self._drained:
            self._requests_counter().inc(event="rejected")
            raise ServerOverloaded("draining")
        if self._overload is not None and self._overload.overloaded:
            # step() feeds the detector only while there is work: an idle
            # engine folds the empty queue's zero delay in here, or a
            # tripped detector would shed all future traffic
            if not self.scheduler.has_work:
                transition = self._overload.observe(0.0)
                if transition is not None:
                    self._overload_transition(transition)
            if self._overload.overloaded:
                self._requests_counter().inc(event="rejected")
                raise ServerOverloaded(
                    "overload", queue_depth=self.scheduler.queue_depth,
                    ewma_s=self._overload.ewma_s,
                    threshold_s=self._overload.threshold_s)
        if request.adapter and (self.lora is None
                                or self.lora.row(request.adapter) is None):
            # the scheduler checks again at admission, for an unload
            # between now and then
            self._requests_counter().inc(event="rejected")
            raise ValueError(
                f"adapter {request.adapter!r} is not loaded"
                + ("" if self.lora is not None
                   else " (engine has no LoRA manager; set "
                        "ServingConfig.lora_adapters)"))
        try:
            st = self.scheduler.submit(request)
        except ServerOverloaded:
            # a refused newcomer is "rejected"; "shed" is a policy
            # victim that had been queued, so offered = submitted +
            # rejected stays exact
            self._requests_counter().inc(event="rejected")
            raise
        if chaos.active() and chaos.probe("serve.request.poison"):
            st.poisoned = True
        if _trace.enabled():
            # one trace per request, buffered whatever the head coin says
            # (tail retention needs it); a bare trace_id resumes an
            # identity, one with a parent is upstream context
            resumed = (request.trace_id is not None
                       and request.trace_parent is None)
            tr = _trace.get_tracer().start_trace(
                "serve.request", trace_id=request.trace_id,
                sample=(request.trace_sampled
                        if request.trace_sampled is not None
                        else (True if resumed else None)),
                t=st.submitted_t, process=request.trace_process,
                parent=request.trace_parent,
                request_id=request.request_id,
                prompt_len=st.prompt_len,
                max_new_tokens=request.max_new_tokens, resumed=resumed)
            st.trace = tr
            st.trace_spans["queued"] = tr.start_span(
                "queued", t=st.submitted_t)
            if st.poisoned:
                tr.mark_anomaly("chaos",
                                chaos_site="serve.request.poison")
        self._requests_counter().inc(event="submitted")
        if request.tenant:
            get_registry().counter(
                "serve_tenant_requests_total",
                "serving requests by tenant and lifecycle event").inc(
                tenant=request.tenant, event="submitted")
        self._publish_gauges()
        return st

    def cancel(self, request_id: int) -> bool:
        """Client disconnect: cancel a queued request now or an in-flight
        one at the next iteration boundary (its pages are freed there).
        False for an unknown or terminal id."""
        hit = self.scheduler.cancel(request_id)
        if hit:
            self._publish_gauges()
        return hit

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None) -> List[np.ndarray]:
        """Batch convenience: submit, drain, return full sequences
        (prompt + generated) per request, in submission order."""
        states = [self.submit(Request(
            p, max_new_tokens=max_new_tokens,
            sampling=sampling or SamplingParams(),
            eos_token_id=eos_token_id)) for p in prompts]
        self.run()
        return [np.concatenate([st.request.prompt,
                                np.asarray(st.generated, np.int32)])
                for st in states]

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive the scheduler until the queue and slots drain. Raises
        :class:`EngineDrained` when a latched drain signal is honoured
        mid-run."""
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    # -- graceful drain ------------------------------------------------------
    def enable_drain(self, snapshot_dir: str,
                     budget_s: Optional[float] = None,
                     signals=(signal.SIGTERM,)) -> DrainLatch:
        """Install the shutdown latch: SIGTERM (default) is latched by a
        thin handler and honoured at the next iteration boundary, where
        :meth:`step` drains and raises :class:`EngineDrained`. Returns
        the latch (``trigger()`` arms it from code; :meth:`shutdown`
        restores the handlers)."""
        self.config.drain_dir = snapshot_dir
        if budget_s is not None:
            self.config.drain_budget_s = float(budget_s)
        if self._drain_latch is not None:
            self._drain_latch.close()
        self._drain_latch = DrainLatch(signals)
        return self._drain_latch

    def drain(self, snapshot_dir: Optional[str] = None,
              budget_s: Optional[float] = None) -> DrainReport:
        """Graceful shutdown: stop admission, decode in-flight requests
        up to the drain budget, then commit all undone work (queued and
        still in flight) as a snapshot. Every submitted request either
        completed, ended by the client's or its deadline's doing, or is
        in the snapshot."""
        if snapshot_dir is None:
            snapshot_dir = self.config.drain_dir
        budget = (self.config.drain_budget_s if budget_s is None
                  else float(budget_s))
        self._draining = True            # submit() now sheds
        sched = self.scheduler
        completed_before = sched.stats["completed"]
        deadline = self.clock() + max(0.0, budget)
        ls = self._lockstep
        while True:
            # on an mp group the leader's budget decides for every rank
            go = bool(sched.active()) and self.clock() < deadline
            if ls is not None:
                go = ls.share(go)
            if not go:
                break
            try:
                self.step(admit=False)
            except DecodeWatchdogError:
                break                    # a hung card: snapshot the rest
        # a request the client left ends "cancelled", never resurrected
        # on the successor as drained work
        sched.sweep_active()
        sched.honour_queued_cancels()
        if ls is not None:
            ls.sync_ended(sched)
        specs = [request_spec(st) for _, st in sched.active()]
        specs += [request_spec(st) for st in sched.waiting]
        if specs and snapshot_dir is None:
            self._draining = False
            raise ValueError(
                f"drain: {len(specs)} request(s) still pending but no "
                "snapshot_dir is configured — refusing to discard work "
                "(pass snapshot_dir or ServingConfig.drain_dir)")
        path = None
        if specs and (ls is None or ls.leader):
            path = save_drain_snapshot(snapshot_dir, specs)
        if ls is not None:
            # one snapshot of the group's work, the leader's
            path = ls.share(path)
        for _, st in list(sched.active()):
            sched.drain_release(st)
        for st in list(sched.waiting):
            sched.drain_release(st)
        completed = sched.stats["completed"] - completed_before
        _flight.safe_record_event("drained", completed=completed,
                                  snapshotted=len(specs), path=path)
        self._drained = True
        self._publish_gauges()
        return DrainReport(completed=completed, snapshotted=len(specs),
                           path=path)

    # -- live weight hot-swap -------------------------------------------------
    def _swaps_counter(self):
        return get_registry().counter(
            "serve_swaps_total",
            "weight hot-swap lifecycle events (staged/cutover/refused/"
            "rolled_back/committed/drain_fallback)")

    def swap_weights(self, manifest_dir: str, mode: str = "auto") -> dict:
        """Load, verify and swap in a candidate checkpoint without
        dropping traffic.

        The candidate must be a committed checkpoint of this engine's
        exact parameter dict (names, shapes, dtypes). A torn or
        mismatched push raises :class:`WeightSwapError` with no side
        effect. A valid push is staged beside the live dict and cut over
        at the next iteration boundary (at once when nothing is in
        flight); slots in flight finish on the weights that wrote their
        K/V. ``mode``: ``"auto"`` (stage when the card has room for a
        second tree, else drain), ``"staged"`` or ``"drain"``. Returns a
        dict with ``mode`` and ``epoch`` and each mode's detail.
        Verification runs at ``FLAGS_checkpoint_verify``, never below
        ``manifest``. An engine on an mp group refuses."""
        if self._lockstep is not None:
            raise NotImplementedError(
                "a live weight swap of a tensor-parallel engine is not "
                "ported: every mp rank would have to cut over at the same "
                "boundary")
        if not self._hot_swap:
            raise RuntimeError(
                "FLAGS_serve_hot_swap is off — live weight swap is "
                "disarmed for this engine (the flag is read once at "
                "construction)")
        if mode not in ("auto", "staged", "drain"):
            raise ValueError(
                f"swap mode {mode!r}: expected auto|staged|drain")
        from ..distributed import checkpoint as ckpt
        state = None
        if chaos.active() and chaos.probe("serve.swap.torn_manifest"):
            reason = ("chaos serve.swap.torn_manifest: candidate "
                      "manifest torn mid-push")
        else:
            level = get_flag("checkpoint_verify")
            reason = ckpt.verify_checkpoint(
                manifest_dir,
                level="manifest" if level == "off" else level)
        if reason is None:
            try:
                state = ckpt.load(manifest_dir)
            except Exception as e:
                reason = f"load failed ({type(e).__name__}: {e})"
        if reason is None:
            reason = self._validate_candidate(state)
        if reason is not None:
            self._swap_stats["refused"] += 1
            self._swaps_counter().inc(event="refused")
            _flight.safe_record_event("swap_refused", manifest=manifest_dir,
                                      reason=reason)
            raise WeightSwapError(manifest_dir, reason)
        tree = {name: state[name].to(live.device)
                for name, live in self.params.items()}
        if chaos.active() and chaos.probe("serve.swap.bad_weights"):
            # damage that passes verification: NaN in the first floating
            # tensor, which shows as non-finite logits in flight (the
            # swap scans no values)
            for name, t in tree.items():
                if t.is_floating_point():
                    tree[name] = torch.full_like(t, float("nan"))
                    break
        if mode == "auto":
            mode = "staged" if self._swap_headroom_ok(tree) else "drain"
        if mode == "drain":
            return self._swap_via_drain(tree, manifest_dir)
        return self._stage(tree, manifest_dir)

    def _validate_candidate(self, state) -> Optional[str]:
        """None when ``state`` is exactly this engine's parameter dict
        (names, shapes, dtypes), else the refusal's reason."""
        if not isinstance(state, dict):
            return ("candidate is not a param dict "
                    f"({type(state).__name__})")
        live, cand = set(self.params), set(state)
        if live != cand:
            missing = sorted(live - cand)[:3]
            extra = sorted(cand - live)[:3]
            return ("param tree mismatch"
                    + (f"; missing {missing}" if missing else "")
                    + (f"; unexpected {extra}" if extra else ""))
        for name, ref in self.params.items():
            t = state[name]
            if not torch.is_tensor(t):
                return f"{name} is not a tensor ({type(t).__name__})"
            if tuple(t.shape) != tuple(ref.shape):
                return (f"shape mismatch at {name}: candidate "
                        f"{tuple(t.shape)} vs serving {tuple(ref.shape)}")
            if t.dtype != ref.dtype:
                return (f"dtype mismatch at {name}: candidate "
                        f"{str(t.dtype).replace('torch.', '')} vs serving "
                        f"{str(ref.dtype).replace('torch.', '')}")
        return None

    def _swap_headroom_ok(self, tree: dict) -> bool:
        """True when the card (``monitor.memory.device_memory_stats``)
        has room for the candidate's bytes with a 25% margin; a CPU
        engine, which has no such counters, stages."""
        stats = _memory.device_memory_stats(self.device)
        if not stats or not stats.get("bytes_limit"):
            return True
        need = sum(t.numel() * t.element_size() for t in tree.values())
        free = int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
        return free >= need * 1.25

    def _stage(self, tree: dict, manifest_dir: Optional[str]) -> dict:
        self._staged = {"params": tree, "manifest": manifest_dir}
        self._swap_stats["staged"] += 1
        self._swaps_counter().inc(event="staged")
        _flight.safe_record_event("weights_staged", manifest=manifest_dir,
                                  epoch=self._weights_epoch + 1)
        if not self.scheduler.active():
            # nothing in flight: between steps is an iteration boundary
            self._cutover()
        return {"mode": "staged", "epoch": self._weights_epoch,
                "pending": self._staged is not None}

    def _swap_via_drain(self, tree: dict,
                        manifest_dir: Optional[str]) -> dict:
        """The fallback when the card cannot hold two trees: snapshot the
        slots in flight as drain specs, release them (``drained``), cut
        over with nothing in flight, then resubmit every unfinished
        continuation with its client callbacks. Tokens already streamed
        stand; the continuation decodes on the new weights. The waiting
        queue never touched the old weights and stays."""
        sched = self.scheduler
        sched.sweep_active()
        inflight = [(st, request_spec(st)) for _, st in sched.active()]
        for _, st in list(sched.active()):
            sched.drain_release(st)
        self._swap_stats["drain_swaps"] += 1
        self._swaps_counter().inc(event="drain_fallback")
        self._stage(tree, manifest_dir)      # no slot left: cuts over
        resubmitted = []
        for st_old, spec in inflight:
            reqs = requests_from_snapshot([spec])
            if not reqs:
                continue                     # it had its whole budget
            req = reqs[0]
            req.on_token = st_old.request.on_token
            req.stop = st_old.request.stop
            resubmitted.append(self.submit(req))
        _flight.safe_record_event("weights_drain_swap",
                                  resubmitted=len(resubmitted),
                                  manifest=manifest_dir)
        return {"mode": "drain", "epoch": self._weights_epoch,
                "resubmitted": len(resubmitted), "states": resubmitted}

    def _cutover(self) -> None:
        """The swap point (top of :meth:`step`, or at once when idle):
        the staged dict becomes the live one. Slots in flight keep the
        tree that wrote their K/V (``_retired``) until they end; the
        radix prefix cache is flushed, and donation into it detached
        while old-epoch slots remain, since cached pages would carry the
        old weights' K/V into new-epoch admissions."""
        staged, self._staged = self._staged, None
        old_epoch = self._weights_epoch
        actives = [st for _, st in self.scheduler.active()]
        for st in actives:
            if st.weights_epoch is None:
                # admitted before the boundary (possibly on old-weight
                # cached pages): it belongs to the old epoch
                st.weights_epoch = old_epoch
        if actives:
            self._retired[old_epoch] = self.params
        self._previous = {"params": self.params,
                          "manifest": self._live_manifest}
        self._weights_epoch = old_epoch + 1
        self.params = staged["params"]
        self._live_manifest = staged["manifest"]
        if self.prefix_cache is not None:
            # the allocator counts references: clear() drops the tree's
            self.prefix_cache.clear()
            if actives:
                # old-epoch slots ending now must not donate their pages
                # into the fresh tree (free_slot donates only while the
                # cache has one); _retire_unreferenced re-attaches it
                self.cache.prefix_cache = None
        self._swap_stats["cutover"] += 1
        self._swaps_counter().inc(event="cutover")
        get_registry().gauge(
            "serve_weights_epoch",
            "live weights generation (increments at every hot-swap "
            "cutover, including rollback cutovers)").set(
                float(self._weights_epoch))
        _flight.safe_record_event("weights_cutover",
                                  epoch=self._weights_epoch,
                                  manifest=staged["manifest"],
                                  in_flight_old_epoch=len(actives))

    def rollback_weights(self) -> dict:
        """Swap back to the pre-swap weights: the retained tree is
        staged and cut over at the next iteration boundary (at once when
        idle). Afterwards the bad tree is the retained one, which
        :meth:`commit_swap` drops."""
        if not self._hot_swap:
            raise RuntimeError(
                "FLAGS_serve_hot_swap is off — rollback_weights is "
                "disarmed for this engine")
        prev = self._previous
        if prev is None:
            raise WeightSwapError(
                "<previous>", "no previous weights retained (already "
                "committed, or never swapped)")
        self._previous = None
        self._swap_stats["rolled_back"] += 1
        self._swaps_counter().inc(event="rolled_back")
        _flight.safe_record_event("weights_rolled_back",
                                  from_epoch=self._weights_epoch,
                                  to_manifest=prev["manifest"])
        return self._stage(prev["params"], prev["manifest"])

    def commit_swap(self) -> None:
        """Drop the retained pre-swap tree (the rollback anchor);
        ``rollback_weights`` raises afterwards."""
        if self._previous is not None:
            self._previous = None
            self._swap_stats["committed"] += 1
            self._swaps_counter().inc(event="committed")
            _flight.safe_record_event("weights_committed",
                                      epoch=self._weights_epoch)

    def _params_for(self, epoch: Optional[int]) -> dict:
        """The parameter dict of a slot's epoch: the live one for the
        live epoch (and unstamped slots), a retired one in a
        transition."""
        if epoch is None or epoch == self._weights_epoch:
            return self.params
        return self._retired[epoch]

    def _epoch_batches(self, pairs):
        """This iteration's decoding slots as one ``(params, pairs)``
        dispatch per weights epoch. Outside a swap transition (always
        with the flag off) ``_retired`` is empty and this is one batch on
        the live dict: the dispatches of an engine without hot swap."""
        if not self._retired:
            return [(self.params, pairs)] if pairs else []
        by_epoch: Dict[int, list] = {}
        for slot, st in pairs:
            e = self._weights_epoch if st.weights_epoch is None \
                else st.weights_epoch
            by_epoch.setdefault(e, []).append((slot, st))
        return [(self._params_for(e), by_epoch[e]) for e in sorted(by_epoch)]

    def _retire_unreferenced(self) -> None:
        """Free the retired trees no slot in flight references; when the
        last goes the transition is over and donation into the (flushed,
        new-epoch) prefix tree re-attaches."""
        live = {st.weights_epoch for _, st in self.scheduler.active()}
        for e in [e for e in self._retired if e not in live]:
            del self._retired[e]
            _flight.safe_record_event("weights_retired", epoch=e)
        if not self._retired and self.prefix_cache is not None \
                and self.cache.prefix_cache is None:
            self.cache.prefix_cache = self.prefix_cache

    @torch.no_grad()
    def step(self, admit: bool = True) -> bool:
        """One scheduler iteration: honour a latched drain, cancels and
        deadlines at the boundary, feed the overload detector, admit
        (unless ``admit=False``, as a drain steps), one prefill pass over
        every prefilling slot (fresh admissions and chunked prefills
        carried from earlier iterations), then one decode or verify
        dispatch over every decoding slot. Returns has_work. Raises
        :class:`EngineDrained` when a latched drain was honoured, and
        :class:`DecodeWatchdogError` on a watchdog trip (after a prefill
        trip every planned state not yet prefilled is back in the
        queue)."""
        if self._boundary(admit):
            raise EngineDrained(self.drain())
        sched = self.scheduler
        groups = self._plan_prefill_groups()
        for gi, group in enumerate(groups):
            try:
                self._run_prefill(group)
            except DecodeWatchdogError:
                # every state of this plan not yet prefilled (the tripped
                # group and the ones after it) holds a slot but has no
                # token: un-admit them in admission order, or a retried
                # step would decode slots with nothing to feed
                pending = [st for g in groups[gi:] for st in g.states]
                pending.sort(key=lambda st: (st.admitted_t,
                                             st.request.request_id))
                sched.rollback_admission(pending)
                for st in pending:
                    self._trace_requeue(st, "watchdog_rollback")
                raise
        if self._decodable():
            if self._spec_k > 0:
                # drafts staged before the capacity pass, so the verify
                # window's K/V writes land in real pages, never scratch
                self._stage_drafts()
            if self._lockstep is None:
                preempted = sched.ensure_decode_capacity()
            else:
                preempted = self._lockstep.preemptions(
                    sched, sched.ensure_decode_capacity()
                    if self._lockstep.leader else ())
            for st in preempted:
                # recompute-preemption: back to the queue, same trace
                self._trace_requeue(st, "preemption")
            # one decode or verify dispatch per live weights epoch: one
            # batch on the live dict outside a swap transition
            for params, pairs in self._epoch_batches(self._decodable()):
                if any(st.draft for _, st in pairs):
                    self._run_verify(pairs, params)
                else:
                    self._run_decode(pairs, params)
        if self._retired:
            self._retire_unreferenced()
        self._publish_gauges()
        return sched.has_work

    def _boundary(self, admit: bool) -> bool:
        """The iteration boundary's decisions: a latched drain (True:
        drain now, nothing else decided), the cutover of staged weights,
        the expiry and cancel sweeps, the overload detector and the
        admissions. On an mp group the leader makes them and the
        followers take them (:meth:`.lockstep.Lockstep.boundary`)."""
        ls = self._lockstep
        if ls is not None and not ls.leader:
            return ls.boundary(self, False)
        drain = (self._drain_latch is not None
                 and self._drain_latch.triggered and not self._draining)
        admitted = None
        if not drain:
            if self._staged is not None:
                # the cutover point: an iteration boundary, before
                # anything of this step is admitted or dispatched
                self._cutover()
            sched = self.scheduler
            # both sweeps cost nothing without deadlines or cancels, and
            # write the registry only on a lifecycle event
            sched.expire_queued()
            sched.sweep_active()
            if self._overload is not None:
                oldest_t = sched.oldest_waiting_t()
                delay = (self.clock() - oldest_t
                         if oldest_t is not None else 0.0)
                transition = self._overload.observe(delay)
                if transition is not None:
                    self._overload_transition(transition)
            if admit:
                admitted = sched.plan_admissions()
        if ls is not None:
            ls.boundary(self, drain, admitted)
        return drain

    def _decodable(self) -> List[Tuple[int, RequestState]]:
        """Active slots that take a decode/verify row this iteration;
        chunked prefills still mid-prompt do not."""
        return [(slot, st) for slot, st in self.scheduler.active()
                if not st.prefilling]

    def _overload_transition(self, transition: str) -> None:
        reg = get_registry()
        on = transition == "enter"
        reg.gauge("serve_overload",
                  "1 while the queue-delay overload detector is "
                  "tripped (new submits are shed)").set(float(on))
        reg.counter("serve_overload_transitions_total",
                    "overload detector state changes").inc(
            state=transition)
        _flight.safe_record_event("overload", state=transition,
                                  ewma_s=round(self._overload.ewma_s, 4),
                                  threshold_s=self._overload.threshold_s,
                                  queue_depth=self.scheduler.queue_depth)

    def _guarded_dispatch(self, kind: str, job, hang: bool = False):
        """Run one serving dispatch, ``job()`` (forward, sampling and the
        tokens' copy to the host), under the wall-clock watchdog
        (``FLAGS_serve_watchdog_s``). Flag unset and no chaos hang: a
        direct call. Armed: the job runs on the engine's one worker
        thread, under ``torch.no_grad()`` and on the caller's stream and
        device (grad mode and the current stream are per thread). On a
        trip the worker is abandoned and :class:`DecodeWatchdogError`
        raised, its ``retry_safe`` True exactly when the job had not yet
        passed its launch gate (then it never will). An error inside the
        job is raised here as it was."""
        self._dispatch_seq += 1
        timeout_s = float(get_flag("serve_watchdog_s") or 0.0)
        if self._lockstep is not None and (timeout_s > 0.0 or hang):
            # a rank that abandoned its dispatch would leave the others
            # inside its collectives
            raise NotImplementedError(
                "the serving dispatch watchdog (FLAGS_serve_watchdog_s, "
                "chaos serve.decode.hang) runs one process's dispatch; on "
                "an mp group FLAGS_collective_timeout_s bounds each of the "
                "forward's collectives instead")
        if timeout_s <= 0.0 and not hang:
            return job()
        if hang and timeout_s <= 0.0:
            raise RuntimeError(
                "chaos site 'serve.decode.hang' fired but "
                "FLAGS_serve_watchdog_s is unset — set a watchdog "
                "budget so the hang can be converted into "
                "DecodeWatchdogError (the path this site exercises)")
        gate = _LaunchGate()
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def guarded():
            if hang:
                # a host-side hang before the dispatch launches anything
                chaos.hang_loop(max(timeout_s, 1.0) * 20 + 60.0)
            _LAUNCH.gate = gate
            try:
                with torch.no_grad(), (
                        torch.cuda.stream(stream) if stream is not None
                        else contextlib.nullcontext()):
                    return job()
            finally:
                _LAUNCH.gate = None

        worker = self._watchdog_worker
        if worker is None or not worker.usable:
            worker = DispatchWorker()
            self._watchdog_worker = worker
            self._watchdog_threads = [x for x in self._watchdog_threads
                                      if x.is_alive()]
            self._watchdog_threads.append(worker.thread)
        result = worker.dispatch(guarded, timeout_s)
        if result is None:
            retry_safe = not gate.abandon()
            # /readyz reports the trip until a later guarded dispatch
            # returns: a replica whose card hangs leaves the balancer
            self._watchdog_tripped = {
                "kind": kind, "timeout_s": timeout_s,
                "dispatch": self._dispatch_seq}
            n_active = len(self.scheduler.active())
            for _, st in self.scheduler.active():
                if st.trace is not None:
                    st.trace.mark_anomaly("watchdog", watchdog_kind=kind)
            get_registry().counter(
                "serve_watchdog_trips_total",
                "serving dispatch watchdog trips").inc(kind=kind)
            _flight.safe_record_event(
                "decode_watchdog", kind=kind, timeout_s=timeout_s,
                dispatch=self._dispatch_seq, active_slots=n_active,
                retry_safe=retry_safe)
            if _flight.enabled():
                _flight.trip_dump(step=self._dispatch_seq,
                                  reason="serve_watchdog", kind=kind,
                                  timeout_s=timeout_s)
            raise DecodeWatchdogError(kind, timeout_s, self._dispatch_seq,
                                      n_active, retry_safe=retry_safe)
        self._watchdog_tripped = None      # the card answers again
        if "error" in result:
            raise result["error"]
        return result["value"]

    # -- dispatches ---------------------------------------------------------
    def _chunk_len(self, st: RequestState) -> int:
        remaining = st.prefill_len - st.prefill_pos
        return min(self._chunk, remaining) if self._chunk > 0 else remaining

    def _plan_prefill_groups(self) -> List[AdmissionGroup]:
        """Group every prefilling slot's next chunk into bucketed
        dispatches, keyed by (weights epoch, context, length bucket): a
        chunk at ``pos > 0`` runs the context path, ``pos == 0`` chunks
        the fresh one, and a chunked prefill carried across a hot-swap
        cutover keeps its own tree. Chunk length is
        ``min(serve_prefill_chunk, remaining)``. Within a key, admission
        order, up to the largest batch bucket a dispatch. With chunking
        and the prefix cache off every prefilling slot is a fresh
        admission with its whole effective prompt, the grouping of the
        engine without them; outside a transition the epoch is one."""
        by_key: Dict[Tuple[int, bool, int], List[RequestState]] = {}
        for _, st in self.scheduler.active():
            if not st.prefilling:
                continue
            ep = self._weights_epoch if st.weights_epoch is None \
                else st.weights_epoch
            key = (ep, st.prefill_pos > 0,
                   self.buckets.len_bucket(self._chunk_len(st)))
            by_key.setdefault(key, []).append(st)
        groups: List[AdmissionGroup] = []
        mb = self.buckets.max_batch
        for key in sorted(by_key):
            sts = sorted(by_key[key], key=lambda s: (s.admitted_t,
                                                     s.request.request_id))
            for i in range(0, len(sts), mb):
                chunk = sts[i:i + mb]
                groups.append(AdmissionGroup(
                    key[2], self.buckets.batch_bucket(len(chunk)), chunk))
        return groups

    def _sampling_arrays(self, states: Sequence[Optional[RequestState]]):
        n = len(states)
        temps = np.ones((n,), np.float32)
        tks = np.zeros((n,), np.int64)
        tps = np.ones((n,), np.float32)
        for i, st in enumerate(states):
            if st is None:
                continue
            s = st.request.sampling
            temps[i], tks[i], tps[i] = s.temperature, s.top_k, s.top_p
        dev = self.device
        return (torch.from_numpy(temps).to(dev), torch.from_numpy(tks).to(dev),
                torch.from_numpy(tps).to(dev))

    @staticmethod
    def _poison(logits, states, row: Optional[int] = None):
        """NaN into the logits of the requests chaos marked
        (``serve.request.poison``; at sequence position ``row`` of a
        ``[B, S, V]`` tensor), ahead of the finiteness checks, as the JAX
        engine's additive poison array does. Without a marked request it
        returns ``logits`` untouched and launches nothing."""
        idx = [i for i, st in enumerate(states)
               if st is not None and st.poisoned]
        if not idx:
            return logits
        logits = logits.clone()
        if row is None:
            logits[idx] = float("nan")
        else:
            logits[idx, row] = float("nan")
        return logits

    def _measure(self, kind: str):
        """The device-memory peak of this kind's first dispatch, under
        ``FLAGS_monitor`` (``monitor.memory.ProgramMemory``)."""
        if kind in self._measured_kinds or not _monitor_enabled():
            return contextlib.nullcontext()
        self._measured_kinds.add(kind)
        return _memory.measure_program(kind, self.device)

    def _sample(self, rows, states):
        """Next token and finiteness per row, on the host (on an mp
        group the leader's, from the whole vocabulary's logits)."""
        rows = self._full_logits(rows)
        ls = self._lockstep
        if ls is not None and not ls.leader:
            return ls.share()
        ok = torch.isfinite(rows).all(dim=-1)
        toks = sample_tokens(rows, *self._sampling_arrays(states),
                             generator=self._generator, finite=ok)
        out = toks.cpu().numpy(), ok.cpu().numpy()
        return out if ls is None else ls.share(out)

    def _forward(self, ids: np.ndarray, states, pos: np.ndarray,
                 context: bool = False, params: Optional[dict] = None):
        """One forward over the paged view with ``params`` (the live
        dict by default); ``states`` has one entry per batch row, None
        for a padded row or a slot that takes no row (an all-scratch
        table row and the zero adapter). ``context`` selects the
        context-prefill path: rows start at ``pos`` and attend over
        every page-resident position before them. Inside a guarded
        dispatch it passes the dispatch's launch gate first."""
        gate = getattr(_LAUNCH, "gate", None)
        if gate is not None:
            gate.enter()
        dev = self.device
        c = self.cache
        lora = (None, None, None)
        if self.lora is not None:
            lora = (self.lora.a, self.lora.b, self.lora.rows_for(
                [None if st is None else st.request.adapter
                 for st in states]))
        table = c.table_rows([None if st is None else st.slot
                              for st in states])
        args = (c.k, c.v, torch.from_numpy(table).to(dev), c.k_scale,
                c.v_scale, *lora)
        view = PagedCacheView(*args, context_index(
            table, pos, ids.shape[1], c.block_size, dev) if context else None)
        return functional_call(
            self.model, (self.params if params is None else params,
                         self.buffers),
            (torch.from_numpy(ids).to(dev),),
            {"caches": view, "cache_pos": torch.from_numpy(pos).to(dev)})

    def _run_prefill(self, group: AdmissionGroup) -> None:
        nb, sp = group.batch_bucket, group.len_bucket
        states: List[Optional[RequestState]] = list(group.states)
        states += [None] * (nb - len(states))
        ids = np.zeros((nb, sp), np.int64)
        lens = np.ones((nb,), np.int64)
        pos = np.zeros((nb,), np.int32)
        chunked = False
        # padded rows (None) get an all-scratch table row, so their K/V
        # writes never land in a live slot's pages
        for i, st in enumerate(states):
            if st is None:
                continue
            eff = st.effective_prompt()
            clen = self._chunk_len(st)
            chunked = chunked or clen < st.prefill_len - st.prefill_pos
            # copy-on-write: writes start at prefill_pos, never below
            # the shared prefix, so a shared page is read-only here
            if st.prefill_pos < (self.cache.slot_shared_blocks(st.slot)
                                 * self.cache.block_size):
                raise RuntimeError(
                    f"slot {st.slot} would write into its shared prefix")
            ids[i, :clen] = eff[st.prefill_pos:st.prefill_pos + clen]
            lens[i] = clen
            pos[i] = st.prefill_pos
        ctx = bool(pos.any())
        t0 = self.clock()
        if self._t_first_work is None:
            self._t_first_work = t0
        # a residency's epoch is stamped at its first chunk: the K/V this
        # dispatch writes belong to that tree, and its later chunks and
        # decodes keep it across a cutover (groups have one epoch)
        for st in group.states:
            if st.weights_epoch is None:
                st.weights_epoch = self._weights_epoch
        params = self._params_for(group.states[0].weights_epoch)
        for st in group.states:
            tr = st.trace
            if tr is not None and "admitted" not in st.trace_spans:
                # queued ends and admitted opens at the admission stamp
                # (a chunked prefill opens them at its first chunk)
                qs = st.trace_spans.pop("queued", None)
                if qs is not None:
                    tr.end_span(qs, t=st.admitted_t)
                st.trace_spans["admitted"] = tr.start_span(
                    "admitted", t=st.admitted_t, slot=st.slot,
                    prefix_hit_tokens=st.prefill_pos)

        def job():
            with self._measure("prefill"):
                logits = self._forward(ids, states, pos, context=ctx,
                                       params=params)
                last = logits[torch.arange(nb, device=self.device),
                              torch.from_numpy(lens - 1).to(self.device)]
                return self._sample(self._poison(last, states), states)
        # a DecodeWatchdogError here reaches step(), which rolls back
        # every planned state not yet prefilled
        toks, ok = self._guarded_dispatch("prefill", job)
        now = self.clock()
        st_ = self._stats
        st_["prefill_dispatches"] += 1
        st_["context_prefill_dispatches"] += int(ctx)
        reg = get_registry()
        if chunked or self._chunk > 0:
            st_["prefill_chunks"] += len(group.states)
            reg.counter("serve_prefill_chunks_total",
                        "chunked-prefill chunk rows dispatched"
                        ).inc(len(group.states))
        reg.histogram("serve_prefill_seconds",
                      "prefill dispatch wall time").observe(
            now - t0, bucket=f"b{nb}_s{sp}")
        for i, st in enumerate(states):
            if st is None:
                continue
            st.prefill_pos += int(lens[i])
            st_["prefill_tokens"] += int(lens[i])
            tr = st.trace
            if tr is not None:
                tr.end_span(tr.start_span(
                    "prefill", parent=st.trace_spans.get("admitted"),
                    t=t0, bucket=f"b{nb}_s{sp}", pos=int(pos[i]),
                    tokens=int(lens[i])), t=now)
            if not ok[i]:
                self.scheduler.fail(st, "non-finite logits at prefill")
                continue
            if st.prefill_pos >= st.prefill_len:
                self._accept_token(st, int(toks[i]), now)

    def _stage_drafts(self) -> None:
        """Prompt-lookup drafting: up to ``k`` draft tokens per decoding
        slot from its own history, never past its token budget (the
        bonus token needs one). No draft anywhere: the iteration runs
        the plain decode dispatch."""
        proposed = 0
        for _, st in self._decodable():
            st.draft = []
            budget = min(self._spec_k, st.remaining_new_tokens() - 1)
            if budget <= 0:
                continue
            hist = np.concatenate([st.request.prompt,
                                   np.asarray(st.generated, np.int32)])
            st.draft = [int(t) for t in propose_ngram(
                hist, budget, max_ngram=self._spec_ngram)]
            proposed += len(st.draft)
        if proposed:
            self._stats["spec_proposed"] += proposed
            get_registry().counter(
                "serve_spec_proposed_total",
                "speculative draft tokens proposed").inc(proposed)

    def _run_verify(self, pairs, params: dict) -> None:
        """ONE verify dispatch over the decoding slots: row 0 is each
        slot's plain decode step, rows 1..k score its staged draft. A
        greedy slot commits the accepted prefix plus one bonus token
        (token-exact with plain decode); a sampled slot accepts draft
        ``i`` with probability ``p_i(d_i)`` under its filtered
        distribution and, on a reject, commits the residual redraw and
        stops (the same marginal distribution as plain sampled decode).
        Pages holding only the rejected tail's K/V roll back by
        block-table truncation."""
        B = self.config.max_batch_slots
        S = self._spec_k + 1
        pos = np.zeros((B,), np.int32)
        ids = np.zeros((B, S), np.int64)
        per_slot: List[Optional[RequestState]] = [None] * B
        for slot, st in pairs:
            pos[slot] = st.seq_len - 1
            ids[slot, 0] = st.generated[-1]
            ids[slot, 1:1 + len(st.draft)] = st.draft
            per_slot[slot] = st
        t0 = self.clock()
        sampled_any = any(st.request.sampling.temperature > 0.0
                          for _, st in pairs)

        def job():
            logits = self._full_logits(self._forward(
                ids, per_slot, pos, context=True, params=params))
            ls = self._lockstep
            if ls is not None and not ls.leader:
                return ls.share()
            logits = self._poison(logits, per_slot, row=0)   # [B, S, V]
            samp = self._sampling_arrays(per_slot)
            ok_rows = torch.isfinite(logits).all(dim=-1)
            tok0 = sample_tokens(logits[:, 0], *samp,
                                 generator=self._generator,
                                 finite=ok_rows[:, 0])
            greedy = torch.argmax(logits, dim=-1)
            draws = (None, None, None)
            if sampled_any:
                drafts = torch.from_numpy(ids[:, 1:]).to(self.device)
                draws = tuple(t.cpu().numpy() for t in verify_draws(
                    logits, drafts, *samp, generator=self._generator))
            out = tuple(t.cpu().numpy()
                        for t in (tok0, greedy, ok_rows)) + draws
            return out if ls is None else ls.share(out)
        hang = chaos.active() and chaos.probe("serve.decode.hang")
        tok0, greedy, ok_rows, p_draft, tok_full, tok_resid = \
            self._guarded_dispatch("verify", job, hang=hang)
        now = self.clock()
        st_ = self._stats
        st_["decode_dispatches"] += 1
        st_["verify_dispatches"] += 1
        st_["decode_slot_steps"] += len(pairs)
        st_["decode_batch_max"] = max(st_["decode_batch_max"], len(pairs))
        self._lat["decode_step"].append(now - t0)
        self._observe_decode(now - t0, len(pairs))
        accepted = rolled_back = 0
        for slot, st in pairs:
            n = len(st.draft)
            tr = st.trace
            if tr is not None:
                tr.end_span(tr.start_span(
                    f"verify[{len(st.generated)}]",
                    parent=st.trace_spans.get("admitted"), t=t0,
                    batch=len(pairs), proposed=n), t=now)
            if not ok_rows[slot, 0]:
                st.draft = []
                self.scheduler.fail(st, "non-finite logits at decode")
                continue
            sampled = st.request.sampling.temperature > 0.0
            if not sampled:
                # draft i survives iff it equals the previous row's
                # argmax and that row is finite
                n_acc = 0
                while n_acc < n and ok_rows[slot, n_acc] \
                        and st.draft[n_acc] == int(greedy[slot, n_acc]):
                    n_acc += 1
                commit = [int(tok0[slot])] + \
                    [int(greedy[slot, i]) for i in range(1, n_acc + 1)
                     if ok_rows[slot, i]]
            else:
                commit = []
                n_acc = 0
                for i in range(n):
                    if not ok_rows[slot, i]:
                        break
                    if self._spec_rng.random() < float(p_draft[slot, i]):
                        commit.append(int(st.draft[i]))
                        n_acc += 1
                    else:
                        commit.append(int(tok_resid[slot, i]))
                        break
                else:
                    if n == 0:
                        commit.append(int(tok0[slot]))
                    elif ok_rows[slot, n]:
                        commit.append(int(tok_full[slot, n]))
            committed = 0
            for t in commit:
                self._accept_token(st, t, now)
                committed += 1
                if st.terminal or st.is_done():
                    break
            acc = min(n_acc, committed) if sampled \
                else max(0, committed - 1)
            accepted += acc
            rolled_back += n - acc
            st.draft = []
            if not st.terminal:
                self.cache.truncate_slot(st.slot, st.seq_len)
        reg = get_registry()
        if accepted:
            st_["spec_accepted"] += accepted
            reg.counter("serve_spec_accepted_total",
                        "speculative draft tokens accepted and "
                        "committed").inc(accepted)
        if rolled_back:
            st_["spec_rolled_back"] += rolled_back
            reg.counter("serve_spec_rolled_back_total",
                        "speculative draft tokens rejected and rolled "
                        "back by block-table truncation").inc(rolled_back)

    def _run_decode(self, pairs, params: dict) -> None:
        B = self.config.max_batch_slots
        pos = np.zeros((B,), np.int32)
        tokens = np.zeros((B, 1), np.int64)
        per_slot: List[Optional[RequestState]] = [None] * B
        for slot, st in pairs:
            # the newest generated token is not yet in the cache: this
            # step writes its K/V at position seq_len-1 and attends over
            # everything up to and including it
            pos[slot] = st.seq_len - 1
            tokens[slot, 0] = st.generated[-1]
            per_slot[slot] = st
        t0 = self.clock()

        def job():
            with self._measure("decode"):
                logits = self._forward(tokens, per_slot, pos,
                                       params=params)
                return self._sample(
                    self._poison(logits[:, -1], per_slot), per_slot)
        hang = chaos.active() and chaos.probe("serve.decode.hang")
        toks, ok = self._guarded_dispatch("decode", job, hang=hang)
        now = self.clock()
        st_ = self._stats
        st_["decode_dispatches"] += 1
        st_["decode_slot_steps"] += len(pairs)
        st_["decode_batch_max"] = max(st_["decode_batch_max"], len(pairs))
        self._lat["decode_step"].append(now - t0)
        self._observe_decode(now - t0, len(pairs))
        for slot, st in pairs:
            tr = st.trace
            if tr is not None:
                # decode[i]: this request's share of the batched dispatch
                # that produced its token i
                tr.end_span(tr.start_span(
                    f"decode[{len(st.generated)}]",
                    parent=st.trace_spans.get("admitted"), t=t0,
                    batch=len(pairs)), t=now)
            if not ok[slot]:
                self.scheduler.fail(st, "non-finite logits at decode")
                continue
            self._accept_token(st, int(toks[slot]), now)

    def _observe_decode(self, dt: float, n_active: int) -> None:
        reg = get_registry()
        reg.histogram("serve_decode_step_seconds",
                      "decode dispatch wall time (all slots)").observe(dt)
        reg.histogram("serve_decode_occupancy",
                      "active slots per decode dispatch",
                      buckets=tuple(range(1, self.config.max_batch_slots
                                          + 1))).observe(n_active)

    def _accept_token(self, st: RequestState, token: int,
                      now: float) -> None:
        tr = st.trace
        # histogram exemplars link a latency bucket to the trace that
        # landed in it (None: no trace)
        ex = tr.trace_id if tr is not None else None
        if st.first_token_t is None:
            st.first_token_t = now
            ttft = now - st.submitted_t
            self._lat["ttft"].append(ttft)
            get_registry().histogram(
                "serve_ttft_seconds",
                "submit -> first token latency").observe(
                ttft, exemplar=ex)
        st.generated.append(token)
        self._stats["tokens_generated"] += 1
        self._t_last_token = now
        get_registry().counter(
            "serve_tokens_generated_total",
            "tokens sampled across all requests").inc()
        req = st.request
        det_sp = None
        if tr is not None and (req.on_token is not None
                               or req.stop is not None
                               or self.config.detokenizer is not None):
            det_sp = tr.start_span("detok", t=self.clock(),
                                   parent=st.trace_spans.get("admitted"))
        try:
            if chaos.active() and chaos.probe("serve.detok.raise"):
                raise chaos.ChaosFault("serve.detok.raise")
            if req.on_token is not None:
                text = None
                if self.config.detokenizer is not None:
                    text = self.config.detokenizer.piece(
                        token, is_first=len(st.generated) == 1)
                req.on_token(req, token, text)
            if req.stop is not None and req.stop(list(st.generated)):
                st.stop_hit = True
        except Exception as e:
            # a raising detokenizer, client callback or stop condition
            # fails ONLY its own request; the rest of the batch streams on
            if det_sp is not None:
                tr.end_span(det_sp, t=self.clock(), error=repr(e))
            self.scheduler.fail(st,
                                f"detokenizer/callback error: {e!r}")
            return
        if det_sp is not None:
            tr.end_span(det_sp, t=self.clock())
        if st.is_done():
            self.scheduler.finish(st)
            e2e = now - st.submitted_t
            self._lat["e2e"].append(e2e)
            n = len(st.generated)
            reg = get_registry()
            if n > 1:
                tpot = (now - st.first_token_t) / (n - 1)
                self._lat["tpot"].append(tpot)
                reg.histogram(
                    "serve_tpot_seconds",
                    "mean per-token decode latency per request"
                ).observe(tpot, exemplar=ex)
            reg.histogram("serve_e2e_seconds",
                          "submit -> completion latency").observe(
                e2e, exemplar=ex)
            if st.deadline_t is not None:
                slack = st.deadline_t - now
                reg.histogram(
                    "serve_deadline_slack_seconds",
                    "deadline minus completion time for deadline-"
                    "carrying requests (negative = finished late)",
                    buckets=self.DEADLINE_SLACK_BUCKETS).observe(
                    slack, exemplar=ex)
                if self._slo_deadline is not None:
                    self._slo_deadline.record(
                        good=1 if slack >= 0 else 0,
                        bad=0 if slack >= 0 else 1)
                    self._slo_deadline.publish()

    def _publish_gauges(self) -> None:
        reg = get_registry()
        reg.gauge("serve_queue_depth",
                  "requests waiting for a batch slot").set(
            self.scheduler.queue_depth)
        reg.gauge("serve_active_slots", "requests holding a batch slot"
                  ).set(len(self.scheduler.active()))
        reg.gauge("serve_kv_pages_in_use",
                  "allocated KV pages (of the shared pool)").set(
            self.cache.allocator.pages_in_use)
        if self.cache.quant:
            reg.gauge(
                "serve_kv_quant_bytes_per_token",
                "HBM bytes per cached token position under "
                "FLAGS_serve_kv_quant (int8 pages + f32 per-head "
                "scales)").set(float(self.cache.kv_bytes_per_token()))
        if self.scheduler.tenant_quota is not None:
            # delta-publish the per-tenant quota deferrals
            for tenant, n in self.scheduler.tenant_deferrals.items():
                delta = n - self._quota_published.get(tenant, 0)
                if delta > 0:
                    reg.counter(
                        "serve_tenant_quota_deferrals_total",
                        "admissions deferred by the per-tenant slot "
                        "quota").inc(delta, tenant=tenant)
                    self._quota_published[tenant] = n
        if self.prefix_cache is not None:
            self._publish_prefix_metrics(reg)

    def _publish_prefix_metrics(self, reg) -> None:
        """Delta-publish the prefix cache's host-side stats (the cache
        never touches the registry). Prefix cache off: never called."""
        pc = self.prefix_cache
        reg.gauge("serve_prefix_cached_pages",
                  "KV pages resident in the radix prefix cache").set(
            pc.cached_pages)
        for stat, name, help_ in (
                ("hits", "serve_prefix_hits_total",
                 "admissions that matched a cached prefix"),
                ("misses", "serve_prefix_misses_total",
                 "admissions with no cached prefix"),
                ("hit_tokens", "serve_prefix_hit_tokens_total",
                 "prompt tokens served from cached pages instead of "
                 "prefill"),
                ("evicted_pages", "serve_prefix_evicted_pages_total",
                 "cached pages evicted under allocation pressure")):
            delta = pc.stats[stat] - self._prefix_published.get(stat, 0)
            if delta > 0:
                # emits-metrics: serve_prefix_hits_total, serve_prefix_misses_total
                # emits-metrics: serve_prefix_hit_tokens_total, serve_prefix_evicted_pages_total
                reg.counter(name, help_).inc(delta)
                self._prefix_published[stat] = pc.stats[stat]

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        d = dict(self._stats)
        d.update(self.scheduler.stats)
        d["queue_depth"] = self.scheduler.queue_depth
        d["active_slots"] = len(self.scheduler.active())
        d["kv_pages_in_use"] = self.cache.allocator.pages_in_use
        if self.prefix_cache is not None:
            d["prefix_cache"] = dict(self.prefix_cache.stats,
                                     cached_pages=
                                     self.prefix_cache.cached_pages)
        if self.lora is not None:
            d["lora"] = {
                "loaded": self.lora.loaded(),
                "swaps": self.lora.swaps,
                "refcounts": {n: self.lora.refcount(n)
                              for n in self.lora.loaded()},
            }
        if self.scheduler.tenant_quota is not None:
            d["tenant_deferrals"] = dict(self.scheduler.tenant_deferrals)
        return d

    def metrics_summary(self) -> dict:
        """Host-clock latency/throughput summary (exact percentiles over
        the raw per-request samples)."""

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else None

        elapsed = None
        if self._t_first_work is not None and self._t_last_token is not None:
            elapsed = max(self._t_last_token - self._t_first_work, 1e-9)
        lat, s = self._lat, self._stats
        hit = (self.prefix_cache.stats["hit_tokens"]
               if self.prefix_cache is not None else 0)
        return {
            "requests_submitted": self.scheduler.stats["submitted"],
            "requests_completed": self.scheduler.stats["completed"],
            "requests_expired": self.scheduler.stats["expired"],
            "requests_expired_queued":
                self.scheduler.stats["expired_queued"],
            "requests_shed": self.scheduler.stats["shed"],
            "requests_cancelled": self.scheduler.stats["cancelled"],
            "requests_failed": self.scheduler.stats["failed"],
            "requests_drained": self.scheduler.stats["drained"],
            "preemptions": self.scheduler.stats["preemptions"],
            "tokens_generated": s["tokens_generated"],
            "elapsed_s": elapsed,
            "tokens_per_sec": (s["tokens_generated"] / elapsed
                               if elapsed else None),
            "ttft_p50_s": pct(lat["ttft"], 50),
            "ttft_p99_s": pct(lat["ttft"], 99),
            "tpot_p50_s": pct(lat["tpot"], 50),
            "tpot_p99_s": pct(lat["tpot"], 99),
            "decode_step_p50_s": pct(lat["decode_step"], 50),
            "decode_step_p99_s": pct(lat["decode_step"], 99),
            "prefill_dispatches": s["prefill_dispatches"],
            "decode_dispatches": s["decode_dispatches"],
            "mean_decode_occupancy": (
                s["decode_slot_steps"] / s["decode_dispatches"]
                if s["decode_dispatches"] else None),
            "prefill_tokens": s["prefill_tokens"],
            "prefill_chunks": s["prefill_chunks"],
            "verify_dispatches": s["verify_dispatches"],
            # share of prompt positions served from cached pages instead
            # of prefill compute (None without a prefix cache)
            "prefix_hit_pct": (100.0 * hit / max(1, hit
                                                 + s["prefill_tokens"])
                               if self.prefix_cache is not None else None),
            "prefix_hit_tokens": hit,
            # committed draft tokens per proposed
            "spec_accept_pct": (100.0 * s["spec_accepted"]
                                / s["spec_proposed"]
                                if s["spec_proposed"] else None),
            "spec_proposed": s["spec_proposed"],
            "spec_accepted": s["spec_accepted"],
            "spec_rolled_back": s["spec_rolled_back"],
            "kv_bytes_per_token": self.cache.kv_bytes_per_token(),
            "quota_deferred": self.scheduler.stats["quota_deferred"],
            "weights_epoch": self._weights_epoch,
            "weight_swaps": self._swap_stats["cutover"],
            "weight_swaps_refused": self._swap_stats["refused"],
            "weight_swap_rollbacks": self._swap_stats["rolled_back"],
        }

    def shutdown(self) -> None:
        """Tear the engine down: leave the admin plane, restore the drain
        latch's signal handlers, stop the watchdog's worker and join
        abandoned ones (their chaos hangs cancelled first), drop every
        request and page (the prefix cache's too) and release the pools'
        device memory. The engine serves nothing afterwards."""
        self._detach_admin()
        if self._drain_latch is not None:
            self._drain_latch.close()
            self._drain_latch = None
        if self._watchdog_worker is not None:
            self._watchdog_worker.close()
            self._watchdog_worker = None
        if self._watchdog_threads:
            # a thread abandoned in a chaos hang exits once the hang is
            # cancelled; one stuck in real work is a daemon
            chaos.cancel_hangs()
            for t in self._watchdog_threads:
                t.join(timeout=0.5)
            self._watchdog_threads = []
            # leave hang sites armed for other live engines
            chaos.rearm_hangs()
        self.scheduler.waiting.clear()
        for slot, _ in list(self.scheduler.active()):
            self.cache.free_slot(slot)
            self.scheduler.slots[slot] = None
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
            self.cache.prefix_cache = None
            self.prefix_cache = None
        # a staged, retired or retained tree must not outlive the engine
        self._staged = None
        self._retired.clear()
        self._previous = None
        self.cache.k = self.cache.v = None
        self.cache.k_scale = self.cache.v_scale = None
