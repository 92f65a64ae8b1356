"""Distributed support (counterpart of ``paddle_tpu.distributed``): so
far the single-process checkpoint commit protocol,
:mod:`.checkpoint`."""

from . import checkpoint

__all__ = ["checkpoint"]
