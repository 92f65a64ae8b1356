"""Serving: paged KV cache, continuous-batching scheduler and engine
(counterpart of ``paddle_tpu.serving``)."""

from .detok import StreamingDetokenizer
from .engine import ServingConfig, ServingEngine
from .kv_cache import (BlockAllocator, PagedCacheView, PagedKVCache,
                       PagedLayerCache, blocks_needed, gather_pages,
                       write_pages)
from .sampling import SamplingParams, filtered_logits, sample_tokens
from .scheduler import (AdmissionGroup, BucketTable, Request, RequestState,
                        Scheduler, ServerOverloaded)

__all__ = ["AdmissionGroup", "BlockAllocator", "BucketTable",
           "PagedCacheView", "PagedKVCache", "PagedLayerCache", "Request",
           "RequestState", "SamplingParams", "Scheduler", "ServerOverloaded",
           "ServingConfig", "ServingEngine", "StreamingDetokenizer",
           "blocks_needed", "filtered_logits", "gather_pages",
           "sample_tokens", "write_pages"]
