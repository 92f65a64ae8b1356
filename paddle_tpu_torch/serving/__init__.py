"""Serving: paged KV cache, continuous-batching scheduler and engine,
the radix prefix cache and the n-gram drafter, multi-tenant LoRA pools
and the open-loop load generator (counterpart of
``paddle_tpu.serving``)."""

from .detok import StreamingDetokenizer
from .engine import ServingConfig, ServingEngine
from .kv_cache import (BlockAllocator, ContextIndex, ContextPagedCacheView,
                       ContextPagedLayerCache, PagedCacheView, PagedKVCache,
                       PagedLayerCache, blocks_needed, context_index,
                       dequant_pages, gather_context, gather_context_quant,
                       gather_pages, gather_pages_quant, write_pages,
                       write_pages_quant)
from .loadgen import LoadSpec, build_requests, run_open_loop
from .lora import LoRAManager, save_adapter_checkpoint
from .prefix_cache import RadixPrefixCache
from .sampling import (SamplingParams, filtered_logits, sample_tokens,
                       verify_draws)
from .scheduler import (AdmissionGroup, BucketTable, Request, RequestState,
                        Scheduler, ServerOverloaded)
from .spec_decode import propose_ngram

__all__ = ["AdmissionGroup", "BlockAllocator", "BucketTable", "ContextIndex",
           "ContextPagedCacheView", "ContextPagedLayerCache", "LoRAManager",
           "LoadSpec", "PagedCacheView", "PagedKVCache", "PagedLayerCache",
           "RadixPrefixCache", "Request", "RequestState", "SamplingParams",
           "Scheduler", "ServerOverloaded", "ServingConfig", "ServingEngine",
           "StreamingDetokenizer", "blocks_needed", "build_requests",
           "context_index", "dequant_pages", "filtered_logits",
           "gather_context", "gather_context_quant", "gather_pages",
           "gather_pages_quant", "propose_ngram", "run_open_loop",
           "sample_tokens", "save_adapter_checkpoint", "verify_draws",
           "write_pages", "write_pages_quant"]
