"""Serving: paged KV cache, continuous-batching scheduler and engine,
multi-tenant LoRA pools and the open-loop load generator (counterpart of
``paddle_tpu.serving``)."""

from .detok import StreamingDetokenizer
from .engine import ServingConfig, ServingEngine
from .kv_cache import (BlockAllocator, PagedCacheView, PagedKVCache,
                       PagedLayerCache, blocks_needed, dequant_pages,
                       gather_pages, gather_pages_quant, write_pages,
                       write_pages_quant)
from .loadgen import LoadSpec, build_requests, run_open_loop
from .lora import LoRAManager, save_adapter_checkpoint
from .sampling import SamplingParams, filtered_logits, sample_tokens
from .scheduler import (AdmissionGroup, BucketTable, Request, RequestState,
                        Scheduler, ServerOverloaded)

__all__ = ["AdmissionGroup", "BlockAllocator", "BucketTable", "LoRAManager",
           "LoadSpec", "PagedCacheView", "PagedKVCache", "PagedLayerCache",
           "Request", "RequestState", "SamplingParams", "Scheduler",
           "ServerOverloaded", "ServingConfig", "ServingEngine",
           "StreamingDetokenizer", "blocks_needed", "build_requests",
           "dequant_pages", "filtered_logits", "gather_pages",
           "gather_pages_quant", "run_open_loop", "sample_tokens",
           "save_adapter_checkpoint", "write_pages", "write_pages_quant"]
