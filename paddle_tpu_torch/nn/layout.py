"""Channels-last layout for the vision stacks.

Counterpart of ``paddle_tpu/nn/layout.py``. The JAX package keeps its
public NCHW contract and runs conv / BN / pool chains NHWC inside by
tagging tensors (``channels_last_scope`` and the ``apply`` hooks, with
one transpose at the chain's entry and one at its exit). PyTorch says
the same thing with a memory format: a tensor in
``torch.channels_last`` keeps its logical NCHW shape and holds NHWC in
its strides, cuDNN runs a convolution on it NHWC-native and returns its
output in the same format, and elementwise ops, reductions and pools
carry the format through. A layout-unaware op (``flatten``, a linear
head) sees the logical NCHW shape, so no result depends on the layout
and nothing needs tagging.

``check_data_format`` validates a vision model's 2-D ``data_format``
flag (``layout.py:45-51``); :func:`to_channels_last` is the entry
conversion a model with ``data_format="NHWC"`` (and ``jit.TrainStep``
under ``FLAGS_jit_channels_last``) applies.
"""

from __future__ import annotations

import torch

__all__ = ["check_data_format", "is_channels_last", "to_channels_last"]


def check_data_format(data_format: str) -> str:
    """Validate a vision model's 2-D data_format flag (shared by the whole
    model zoo)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(
            f"data_format must be 'NCHW' or 'NHWC', got {data_format!r}")
    return data_format


def is_channels_last(t: torch.Tensor) -> bool:
    """A 4-D tensor whose strides hold NHWC (and not also NCHW, as a
    tensor with one channel or a 1x1 image does)."""
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def to_channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``torch.channels_last`` memory format when it is a 4-D
    floating tensor, else ``t`` unchanged (no copy when it already is)."""
    if t.dim() != 4 or not t.is_floating_point():
        return t
    return t.contiguous(memory_format=torch.channels_last)
