"""Helpers the ``tensor`` modules share: unwrapping arguments to torch
tensors, wrapping results, axes, shapes and the AMP cast by op name."""

from __future__ import annotations

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs, is_active
from ..core import dtype as dtypes
from ..core.tensor import Tensor, to_torch

wrap = Tensor._wrap


def tt(x) -> torch.Tensor:
    """``x`` as a torch tensor (a facade's own, a torch tensor as it is,
    anything else made on the default device)."""
    if type(x) is Tensor:
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return to_torch(x)


def like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a torch tensor on ``ref``'s device (a scalar or a numpy
    array made there)."""
    if type(x) is Tensor:
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return to_torch(x, place=ref.device)


def arg(x):
    """A binary op's second operand: a facade's tensor, a torch tensor or
    a Python scalar as they are, a numpy value as a tensor."""
    if type(x) is Tensor:
        return x._data
    if isinstance(x, (torch.Tensor, bool, int, float)):
        return x
    if isinstance(x, np.number):
        return x.item()
    return to_torch(x)


def axis_arg(axis):
    """``None``, an int, or a tuple of ints (from a list or a tensor)."""
    if axis is None:
        return None
    if type(axis) is Tensor or isinstance(axis, torch.Tensor):
        axis = tt(axis).tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def all_dims(a: torch.Tensor, axis):
    """``axis`` with ``None`` spelled out as every dimension."""
    ax = axis_arg(axis)
    return tuple(range(a.dim())) if ax is None else ax


def ints(v) -> tuple:
    """A shape or index list (ints, tensors, or a tensor) as ints."""
    if type(v) is Tensor or isinstance(v, torch.Tensor):
        return tuple(int(i) for i in tt(v).reshape(-1).tolist())
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(i.item()) if type(i) is Tensor else int(i) for i in v)


def scalar(v):
    return v.item() if type(v) is Tensor or isinstance(
        v, torch.Tensor) else v


def dt(dtype, default=None):
    d = dtypes.convert_dtype(dtype)
    if d is None:
        d = default if default is not None else dtypes.get_default_dtype()
    return d


def amp(name: str, *ts):
    """The op's inputs under the active AMP policy (``amp.cast_inputs``),
    checked first so that an op outside ``auto_cast`` pays one call."""
    return cast_inputs(name, *ts) if is_active() else ts


def float_of(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself when floating (or complex), else as the default
    float dtype (what jnp promotes integers to)."""
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(dtypes.get_default_dtype())
