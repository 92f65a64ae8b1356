"""Weights carried across from the JAX package.

The port keeps the JAX package's parameter names and layouts, so a
state dict copies by name. The caller turns the JAX model's state dict
into numpy arrays (``{k: np.asarray(v._data) for k, v in
jax_model.state_dict().items()}``); this module never imports the JAX
package.

A model laid on a mesh (``distributed.spmd.apply_param_shardings``)
holds each parameter's block: :func:`shard_state_dict` cuts a full
state dict (the JAX package's or the port's) to this rank's blocks,
:func:`load_jax_weights` does so itself, and :func:`gather_state_dict`
puts the full arrays back together (a collective every rank calls).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["torch_state_dict_from_jax", "load_jax_weights",
           "shard_state_dict", "gather_state_dict"]


def torch_state_dict_from_jax(
        named_arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Copy each named array into a CPU tensor of the same dtype and
    layout."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in named_arrays.items()}


def _layouts(model: nn.Module) -> Dict[str, dict]:
    return {k: p._dist_layout for k, p in model.named_parameters()
            if getattr(p, "_dist_layout", None)}


def shard_state_dict(state: Mapping[str, object], model: nn.Module,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """``state`` (full arrays or tensors by name) with every parameter
    that ``model`` holds sharded cut to this rank's block; other entries
    pass through."""
    from ..distributed import env
    from ..distributed.spmd import shard_tensor
    mesh = mesh or env.get_mesh()
    lay = _layouts(model)
    out = {}
    for k, v in state.items():
        t = torch.as_tensor(v) if not isinstance(v, torch.Tensor) else v
        out[k] = shard_tensor(t, lay[k], mesh).contiguous() if k in lay \
            else t
    return out


@torch.no_grad()
def gather_state_dict(model: nn.Module, mesh=None) -> Dict[str, np.ndarray]:
    """The full state dict of a model laid on a mesh, as host numpy
    (every rank of the mesh calls it)."""
    from ..distributed import env
    from ..distributed.spmd import gather_tensor
    from ..framework.io import to_numpy
    mesh = mesh or env.get_mesh()
    lay = _layouts(model)
    return {k: to_numpy(gather_tensor(v, lay[k], mesh) if k in lay else v)
            for k, v in model.state_dict().items()}


@torch.no_grad()
def load_jax_weights(model: nn.Module,
                     named_arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Load JAX weights into ``model`` strictly: every key of both sides
    must match and every shape must be equal. Values land on the
    model's own device; a floating value takes the model's floating
    dtype, any other value must have the model's dtype already (a
    quantized model's int8 ``weight_q`` buffers beside their float32
    ``scale``), so an integer buffer is never filled by a cast. A model
    laid on a mesh takes this rank's block of each full array. Returns
    ``model``."""
    src = torch_state_dict_from_jax(named_arrays)
    if _layouts(model):
        src = shard_state_dict(src, model)
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
