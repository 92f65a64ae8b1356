"""The functional tensor API and the facade's methods: counterpart of
``paddle_tpu/tensor/__init__.py``.

Every public function of the modules below becomes a method of the
facade ``Tensor`` (the JAX package's ``_attach_methods`` with its skip
list), so ``x.split(2, axis=1)`` is ``paddle.split(x, 2, axis=1)``:
Paddle's meaning on the facade, torch's on a ``torch.Tensor``. The
in-place ``_`` methods compute out of place and rebind the facade (the
JAX ``_adopt``); the operators map onto the same functions, ``&`` /
``|`` / ``^`` / ``~`` onto the logical ops as in the JAX package.
"""

from __future__ import annotations

import operator

from ..core.tensor import Tensor
from . import (creation, linalg, logic, manipulation, math, random, search,
               stat)
from ._base import like, wrap
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

_MODULES = (creation, math, manipulation, logic, search, random, linalg,
            stat)

__all__ = sorted({n for m in _MODULES for n in m.__all__})

_METHOD_SOURCES = (math, manipulation, logic, search, linalg, stat,
                   creation, random)

_SKIP = {
    "to_tensor", "zeros", "ones", "full", "arange", "linspace", "eye",
    "empty", "meshgrid", "rand", "randn", "randint", "randperm", "uniform",
    "normal", "standard_normal", "broadcast_shape", "is_tensor",
    "scatter_nd",
}


def _attach_methods() -> None:
    for mod in _METHOD_SOURCES:
        for name in mod.__all__:
            if name in _SKIP or hasattr(Tensor, name):
                continue
            setattr(Tensor, name, getattr(mod, name))


_attach_methods()

Tensor.transpose = manipulation.transpose
Tensor.scale = math.scale
Tensor.uniform_ = random.uniform_
Tensor.normal_ = random.normal_
Tensor.exponential_ = random.exponential_


def _inplace(name, fn):
    def method(self, *args, **kwargs):
        self._rebind(fn(self, *args, **kwargs)._data)
        return self
    method.__name__ = method.__qualname__ = name
    setattr(Tensor, name, method)


INPLACE = {
    "add_": math.add, "subtract_": math.subtract,
    "multiply_": math.multiply, "scale_": math.scale, "clip_": math.clip,
    "ceil_": math.ceil, "floor_": math.floor, "exp_": math.exp,
    "sqrt_": math.sqrt, "rsqrt_": math.rsqrt,
    "reciprocal_": math.reciprocal, "round_": math.round,
    "abs_": math.abs, "tanh_": math.tanh, "square_": math.square,
    "zero_": lambda self: creation.zeros_like(self),
    "fill_": lambda self, v: creation.full_like(self, v),
}

for _n, _f in INPLACE.items():
    _inplace(_n, _f)


def _other(other, ref):
    """A reflected operator's left operand: a Python scalar as it is,
    anything else as a tensor on ``ref``'s device."""
    if isinstance(other, (bool, int, float)):
        return other
    return like(other, ref)


def _rop(op):
    def method(self, other):
        return wrap(op(_other(other, self._data), self._data))
    return method


def _rmatmul(self, other):
    return math.matmul(_other(other, self._data), self)


Tensor.__add__ = math.add
Tensor.__radd__ = math.add
Tensor.__sub__ = math.subtract
Tensor.__rsub__ = _rop(operator.sub)
Tensor.__mul__ = math.multiply
Tensor.__rmul__ = math.multiply
Tensor.__truediv__ = math.divide
Tensor.__rtruediv__ = _rop(operator.truediv)
Tensor.__floordiv__ = math.floor_divide
Tensor.__rfloordiv__ = _rop(operator.floordiv)
Tensor.__mod__ = math.remainder
Tensor.__rmod__ = _rop(operator.mod)
Tensor.__pow__ = math.pow
Tensor.__rpow__ = _rop(operator.pow)
Tensor.__matmul__ = math.matmul
Tensor.__rmatmul__ = _rmatmul
Tensor.__neg__ = math.neg
Tensor.__abs__ = math.abs
Tensor.__eq__ = logic.equal
Tensor.__ne__ = logic.not_equal
Tensor.__lt__ = logic.less_than
Tensor.__le__ = logic.less_equal
Tensor.__gt__ = logic.greater_than
Tensor.__ge__ = logic.greater_equal
Tensor.__and__ = logic.logical_and
Tensor.__or__ = logic.logical_or
Tensor.__xor__ = logic.logical_xor
Tensor.__invert__ = logic.logical_not

DUNDERS = ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
           "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
           "__rfloordiv__", "__mod__", "__rmod__", "__pow__", "__rpow__",
           "__matmul__", "__rmatmul__", "__neg__", "__abs__", "__eq__",
           "__ne__", "__lt__", "__le__", "__gt__", "__ge__", "__and__",
           "__or__", "__xor__", "__invert__")
