"""Comparison, logical and bitwise ops: counterpart of
``paddle_tpu/tensor/logic.py``. ``masked_select`` and ``nonzero`` have
data-dependent shapes, as in the JAX package (which goes through the
host); here torch computes them on the tensor's device."""

from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._base import arg, like, tt, wrap

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "is_empty", "is_tensor", "where",
    "masked_select", "nonzero",
]


def _cmp(fn):
    def op(x, y, out=None, name=None):
        return wrap(fn(tt(x), arg(y)))
    op.__name__ = op.__qualname__ = fn.__name__
    return op


equal = _cmp(torch.eq)
not_equal = _cmp(torch.ne)
greater_than = _cmp(torch.gt)
greater_equal = _cmp(torch.ge)
less_than = _cmp(torch.lt)
less_equal = _cmp(torch.le)
bitwise_and = _cmp(torch.bitwise_and)
bitwise_or = _cmp(torch.bitwise_or)
bitwise_xor = _cmp(torch.bitwise_xor)


def _logical(fn):
    def op(x, y, out=None, name=None):
        a = tt(x)
        return wrap(fn(a, like(y, a)))
    op.__name__ = op.__qualname__ = fn.__name__
    return op


logical_and = _logical(torch.logical_and)
logical_or = _logical(torch.logical_or)
logical_xor = _logical(torch.logical_xor)


def equal_all(x, y, name=None):
    a = tt(x)
    return wrap(torch.tensor(torch.equal(a, like(y, a)), device=a.device))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = tt(x)
    ok = torch.allclose(a, like(y, a).to(a.dtype), rtol=rtol, atol=atol,
                        equal_nan=equal_nan)
    return wrap(torch.tensor(ok, device=a.device))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = tt(x)
    return wrap(torch.isclose(a, like(y, a).to(a.dtype), rtol=rtol,
                              atol=atol, equal_nan=equal_nan))


def logical_not(x, out=None, name=None):
    return wrap(torch.logical_not(tt(x)))


def bitwise_not(x, out=None, name=None):
    return wrap(torch.bitwise_not(tt(x)))


def is_empty(x, name=None):
    a = tt(x)
    return wrap(torch.tensor(a.numel() == 0, device=a.device))


def is_tensor(x):
    return isinstance(x, (Tensor, torch.Tensor))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition)
    c = tt(condition)
    return wrap(torch.where(c, arg(x), arg(y)))


def masked_select(x, mask, name=None):
    a = tt(x)
    return wrap(torch.masked_select(a, like(mask, a).bool()))


def nonzero(x, as_tuple=False):
    a = tt(x)
    if as_tuple:
        return tuple(wrap(i) for i in torch.nonzero(a, as_tuple=True))
    return wrap(torch.nonzero(a))
