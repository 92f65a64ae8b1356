"""Global configuration flags (the subset the port reads).

Counterpart of ``paddle_tpu/core/flags.py``: one registry, each value
read from the environment (``FLAGS_<name>``) unless :func:`set_flags`
or :func:`flag_scope` set it. The port defines only the flags whose
behaviour it has (``serve_kv_quant``, ``amp_int8_matmul`` and the
serving throughput features ``serve_prefix_cache``,
``serve_prefill_chunk``, ``serve_spec_k``, ``serve_spec_ngram``); it has no
kernel kill switches (the JAX package's
``pallas_*`` flags), because a kernel wrapper on the card launches its
kernel or raises.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["define_flag", "get_flag", "set_flags", "flag_scope"]


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
define_flag("amp_int8_matmul", False,
            "EXPERIMENTAL: under an active amp.auto_cast region, run "
            "nn.functional.linear matmuls whose 2-D weight tiles (K and N "
            "multiples of 128) through the int8 kernel "
            "(ops.kernels.quant_matmul.int8_amp_linear): dynamic "
            "per-tensor activation and per-channel weight quantization, "
            "a straight-through dense backward. Off by default; read at "
            "every call.")
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
