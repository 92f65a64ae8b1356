"""Serving: paged KV cache, continuous-batching scheduler and engine,
the radix prefix cache and the n-gram drafter, multi-tenant LoRA pools,
the resilience plane (deadlines, priorities, cancel, overload shedding,
graceful drain with snapshots, the dispatch watchdog), live weight
hot-swap, the prefix-affine fleet router, the model lifecycle
controller and the open-loop load generator (counterpart of
``paddle_tpu.serving``)."""

import logging

from .detok import StreamingDetokenizer
from .engine import ServingConfig, ServingEngine, WeightSwapError
from .kv_cache import (BlockAllocator, ContextIndex, ContextPagedCacheView,
                       ContextPagedLayerCache, PagedCacheView, PagedKVCache,
                       PagedLayerCache, blocks_needed, context_index,
                       dequant_pages, gather_context, gather_context_quant,
                       gather_pages, gather_pages_quant, write_pages,
                       write_pages_quant)
from .lifecycle import (LifecycleConfig, LifecycleController, TrafficSplit,
                        assign_arm, should_shadow)
from .loadgen import (LoadSpec, TokenBucket, build_requests,
                      run_fleet_open_loop, run_open_loop)
from .lora import LoRAManager, save_adapter_checkpoint
from .prefix_cache import RadixPrefixCache
from .router import FleetRouter, ReplicaHandle, RouterConfig
from .resilience import (DecodeWatchdogError, DrainLatch, DrainReport,
                         EngineDrained, OverloadDetector, ServerOverloaded,
                         load_drain_snapshot, requests_from_snapshot,
                         save_drain_snapshot)
from .sampling import (SamplingParams, filtered_logits, sample_tokens,
                       verify_draws)
from .scheduler import (TERMINAL_OUTCOMES, AdmissionGroup, BucketTable,
                        Request, RequestState, Scheduler)
from .spec_decode import propose_ngram

__all__ = ["AdmissionGroup", "BlockAllocator", "BucketTable", "ContextIndex",
           "ContextPagedCacheView", "ContextPagedLayerCache",
           "DecodeWatchdogError", "DrainLatch", "DrainReport",
           "EngineDrained", "FleetRouter", "LifecycleConfig",
           "LifecycleController", "LoRAManager", "LoadSpec",
           "OverloadDetector", "PagedCacheView", "PagedKVCache",
           "PagedLayerCache", "RadixPrefixCache", "ReplicaHandle", "Request",
           "RequestState", "RouterConfig", "SamplingParams", "Scheduler",
           "ServerOverloaded", "ServingConfig", "ServingEngine",
           "StreamingDetokenizer", "TERMINAL_OUTCOMES", "TokenBucket",
           "TrafficSplit", "WeightSwapError", "assign_arm", "blocks_needed",
           "build_requests", "context_index", "dequant_pages",
           "filtered_logits", "gather_context", "gather_context_quant",
           "gather_pages", "gather_pages_quant", "load_drain_snapshot",
           "propose_ngram", "requests_from_snapshot", "reset",
           "run_fleet_open_loop", "run_open_loop", "sample_tokens",
           "save_adapter_checkpoint", "save_drain_snapshot",
           "should_shadow", "verify_draws", "write_pages",
           "write_pages_quant"]


def reset() -> None:
    """Tear down process-global serving state (test isolation): shut
    down every live engine, which restores any drain latch's signal
    handlers and joins abandoned watchdog threads (their chaos hangs
    cancelled first), then restart the request-id counter."""
    from . import engine as _engine
    from . import scheduler as _scheduler
    for e in list(_engine._LIVE_ENGINES):
        try:
            e.shutdown()
        except Exception:
            logging.getLogger("paddle_tpu_torch.serving").warning(
                "reset: engine shutdown failed", exc_info=True)
    _engine._LIVE_ENGINES.clear()
    _scheduler._reset_request_ids()
