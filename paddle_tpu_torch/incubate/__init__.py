"""Incubating ops, PyTorch port of ``paddle_tpu/incubate``.

``moe`` (loaded on first access, as in the JAX package) and the two
softmax-mask fusions, which are plain compositions there too. The JAX
``LookAhead`` and ``ModelAverage`` (``incubate/optimizer.py``) are not
ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle", "moe"]


def __getattr__(name):
    if name == "moe":
        import importlib
        return importlib.import_module(".moe", __name__)
    raise AttributeError(
        f"module 'paddle_tpu_torch.incubate' has no attribute {name!r}")


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis."""
    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x):
    """Causal softmax over the last axis: entries above the diagonal of
    the last two axes are set to -1e30 first."""
    S = x.shape[-1]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(causal, x, torch.full_like(x, -1e30)),
                         dim=-1)
