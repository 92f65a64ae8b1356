"""Global configuration flags (the subset the port reads).

Counterpart of ``paddle_tpu/core/flags.py``: one registry, each value
read from the environment (``FLAGS_<name>``) unless :func:`set_flags`
or :func:`flag_scope` set it. The port defines only the flags whose
behaviour it has (``serve_kv_quant``, ``amp_int8_matmul``); it has no
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
