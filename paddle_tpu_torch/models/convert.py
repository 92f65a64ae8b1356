"""Weights carried across from the JAX package.

The port keeps the JAX package's parameter names and layouts, so a
state dict copies by name. The caller turns the JAX model's state dict
into numpy arrays (``{k: np.asarray(v._data) for k, v in
jax_model.state_dict().items()}``); this module never imports the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["torch_state_dict_from_jax", "load_jax_weights"]


def torch_state_dict_from_jax(
        named_arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Copy each named array into a CPU tensor of the same dtype and
    layout."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in named_arrays.items()}


@torch.no_grad()
def load_jax_weights(model: nn.Module,
                     named_arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Load JAX weights into ``model`` strictly: every key of both sides
    must match and every shape must be equal. Values land on the
    model's own device; a floating value takes the model's floating
    dtype, any other value must have the model's dtype already (a
    quantized model's int8 ``weight_q`` buffers beside their float32
    ``scale``), so an integer buffer is never filled by a cast. Returns
    ``model``."""
    src = torch_state_dict_from_jax(named_arrays)
    dst = model.state_dict()
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {extra}")
    bad = [f"{k}: {tuple(src[k].shape)} vs {tuple(dst[k].shape)}"
           for k in dst if tuple(src[k].shape) != tuple(dst[k].shape)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    bad = [f"{k}: {src[k].dtype} vs {t.dtype}" for k, t in dst.items()
           if src[k].dtype != t.dtype
           and not (src[k].is_floating_point() and t.is_floating_point())]
    if bad:
        raise TypeError("dtype mismatch: " + "; ".join(bad))
    for k, t in dst.items():
        t.copy_(src[k])
    return model
