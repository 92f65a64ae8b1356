"""Tensor creation: counterpart of ``paddle_tpu/tensor/creation.py``.

New tensors go to the default device (``set_device``, else the card;
without a card these raise unless the caller asked for the CPU). Float
creation takes the default dtype (float32); ``arange`` over integers
gives int64, where the JAX package (x64 off) gives int32.
"""

from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.tensor import Tensor
from ._base import dt, ints, scalar, tt, wrap

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "arange", "linspace", "eye", "empty", "empty_like",
    "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
    "numel", "complex", "real", "imag",
]


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)


def _dev():
    return resolve_device(None)


def zeros(shape, dtype=None, name=None) -> Tensor:
    return wrap(torch.zeros(ints(shape), dtype=dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return wrap(torch.ones(ints(shape), dtype=dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    return wrap(torch.full(ints(shape), scalar(fill_value), dtype=dt(dtype),
                           device=_dev()))


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return wrap(torch.zeros_like(tt(x), dtype=dtypes.convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None) -> Tensor:
    return wrap(torch.ones_like(tt(x), dtype=dtypes.convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return wrap(torch.full_like(tt(x), scalar(fill_value),
                                dtype=dtypes.convert_dtype(dtype)))


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    if end is None:
        start, end = 0, start
    start, end, step = scalar(start), scalar(end), scalar(step)
    if dtype is None:
        dtype = "float32" if any(isinstance(v, float)
                                 for v in (start, end, step)) else "int64"
    return wrap(torch.arange(start, end, step,
                             dtype=dtypes.convert_dtype(dtype),
                             device=_dev()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return wrap(torch.linspace(scalar(start), scalar(stop), int(num),
                               dtype=dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    return wrap(torch.eye(int(num_rows), int(num_columns or num_rows),
                          dtype=dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None) -> Tensor:
    a = tt(x)
    out = torch.diag(a, offset)
    if a.dim() == 1 and padding_value != 0:
        n = out.shape[0]
        mask = torch.ones(n, n, dtype=torch.bool, device=a.device)
        mask = mask.triu(offset) & mask.tril(offset)
        out = torch.where(mask, out, torch.full_like(out, padding_value))
    return wrap(out)


def diagflat(x, offset=0, name=None) -> Tensor:
    return wrap(torch.diagflat(tt(x), offset))


def tril(x, diagonal=0, name=None) -> Tensor:
    return wrap(torch.tril(tt(x), diagonal))


def triu(x, diagonal=0, name=None) -> Tensor:
    return wrap(torch.triu(tt(x), diagonal))


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return [wrap(o) for o in torch.meshgrid(*[tt(t) for t in ts],
                                            indexing="ij")]


def assign(x, output=None) -> Tensor:
    out = wrap(tt(x).clone())
    if output is not None:
        output._rebind(out._data)
        return output
    return out


def clone(x, name=None) -> Tensor:
    return wrap(tt(x).clone())


def numel(x, name=None) -> Tensor:
    a = tt(x)
    return wrap(torch.tensor(a.numel(), dtype=torch.int64, device=a.device))


def complex(real, imag, name=None) -> Tensor:
    return wrap(torch.complex(tt(real), tt(imag)))


def real(x, name=None) -> Tensor:
    return wrap(torch.real(tt(x)))


def imag(x, name=None) -> Tensor:
    return wrap(torch.imag(tt(x)))
