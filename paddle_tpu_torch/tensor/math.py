"""Math ops: counterpart of ``paddle_tpu/tensor/math.py``.

Each op runs the torch op on its arguments' tensors and wraps the
result. Under ``amp.auto_cast`` the ops of the AMP lists (``matmul``,
``bmm``, ``sum``, ``mean``, ``exp``, ...) cast their inputs by the same
names as the JAX ``apply`` does.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor
from ._base import (all_dims, amp, arg, axis_arg, float_of, like, scalar,
                    tt, wrap)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder", "mod",
    "pow", "matmul", "mm", "bmm", "dot", "inner", "outer", "t", "transpose_",
    "scale", "abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "square", "reciprocal", "sign", "floor", "ceil", "round",
    "trunc", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "atan2", "erf", "erfinv", "lgamma",
    "digamma", "sum", "mean", "max", "min", "prod", "amax", "amin",
    "logsumexp", "cumsum", "cumprod", "clip", "maximum", "minimum", "fmax",
    "fmin", "add_n", "multiplex", "isnan", "isinf", "isfinite", "nan_to_num",
    "stanh", "kron", "trace", "all", "any", "broadcast_shape", "lerp",
    "rad2deg", "deg2rad", "gcd", "lcm", "diff", "angle", "frac",
    "count_nonzero", "nansum", "nanmean", "heaviside", "logit", "increment",
]


def _first(x) -> torch.Tensor:
    """A binary op's first operand (a scalar becomes a tensor)."""
    return x._data if type(x) is Tensor else tt(x)


def add(x, y, name=None):
    return wrap(torch.add(_first(x), arg(y)))


def subtract(x, y, name=None):
    return wrap(torch.sub(_first(x), arg(y)))


def multiply(x, y, name=None):
    return wrap(torch.mul(_first(x), arg(y)))


def divide(x, y, name=None):
    return wrap(torch.true_divide(_first(x), arg(y)))


def floor_divide(x, y, name=None):
    return wrap(torch.floor_divide(_first(x), arg(y)))


def remainder(x, y, name=None):
    return wrap(torch.remainder(_first(x), arg(y)))


mod = remainder


def pow(x, y, name=None):
    a, b = _first(x), arg(y)
    a, = amp("pow", a)
    return wrap(torch.pow(a, b))


def _tensor_pair(x, y):
    a = _first(x)
    b = like(y, a)
    return a, b


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = amp("matmul", *_tensor_pair(x, y))
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return wrap(torch.matmul(a, b))


mm = matmul


def bmm(x, y, name=None):
    return wrap(torch.matmul(*amp("bmm", *_tensor_pair(x, y))))


def dot(x, y, name=None):
    a, b = _tensor_pair(x, y)
    return wrap((a * b).sum(-1))


def inner(x, y, name=None):
    return wrap(torch.inner(*_tensor_pair(x, y)))


def outer(x, y, name=None):
    return wrap(torch.outer(*_tensor_pair(x, y)))


def t(x, name=None):
    a = tt(x)
    return wrap(a.permute(*reversed(range(a.dim()))))


def transpose_(x, perm, name=None):
    return wrap(tt(x).permute(*[int(p) for p in perm]))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = scalar(scale)
    a = tt(x)
    out = a * s + bias if bias_after_scale else (a + bias) * s
    out = wrap(out)
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0, name=None):
    x._rebind(tt(x) + value)
    return x


def _unary(fn, name, amp_name=None, to_float=False):
    def op(x, name=None):
        a = tt(x)
        if amp_name is not None:
            a, = amp(amp_name, a)
        return wrap(fn(float_of(a) if to_float else a))
    op.__name__ = op.__qualname__ = name
    return op


abs = _unary(torch.abs, "abs")
neg = _unary(torch.neg, "neg")
exp = _unary(torch.exp, "exp", "exp", True)
expm1 = _unary(torch.expm1, "expm1", None, True)
log = _unary(torch.log, "log", "log", True)
log2 = _unary(torch.log2, "log2", None, True)
log10 = _unary(torch.log10, "log10", None, True)
log1p = _unary(torch.log1p, "log1p", None, True)
sqrt = _unary(torch.sqrt, "sqrt", "sqrt", True)
rsqrt = _unary(torch.rsqrt, "rsqrt", "rsqrt", True)
square = _unary(torch.square, "square", "square")
reciprocal = _unary(torch.reciprocal, "reciprocal", None, True)
sign = _unary(torch.sign, "sign")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")
trunc = _unary(torch.trunc, "trunc")
sin = _unary(torch.sin, "sin", None, True)
cos = _unary(torch.cos, "cos", None, True)
tan = _unary(torch.tan, "tan", None, True)
asin = _unary(torch.asin, "asin", None, True)
acos = _unary(torch.acos, "acos", None, True)
atan = _unary(torch.atan, "atan", None, True)
sinh = _unary(torch.sinh, "sinh", None, True)
cosh = _unary(torch.cosh, "cosh", None, True)
tanh = _unary(torch.tanh, "tanh", None, True)
asinh = _unary(torch.asinh, "asinh", None, True)
acosh = _unary(torch.acosh, "acosh", None, True)
atanh = _unary(torch.atanh, "atanh", None, True)
erf = _unary(torch.special.erf, "erf", "erf", True)
erfinv = _unary(torch.special.erfinv, "erfinv", "erfinv", True)
lgamma = _unary(torch.lgamma, "lgamma", None, True)
digamma = _unary(torch.digamma, "digamma", None, True)
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")
angle = _unary(torch.angle, "angle")


def frac(x, name=None):
    a = tt(x)
    return wrap(a - torch.trunc(a))


def atan2(x, y, name=None):
    a, b = _tensor_pair(x, y)
    return wrap(torch.atan2(float_of(a), float_of(b)))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return wrap(scale_b * torch.tanh(scale_a * tt(x)))


def logit(x, eps=None, name=None):
    a = tt(x)
    if eps is not None:
        a = a.clamp(eps, 1.0 - eps)
    return wrap(torch.log(a / (1.0 - a)))


def heaviside(x, y, name=None):
    return wrap(torch.heaviside(*_tensor_pair(x, y)))


def _reduce(fn, a, axis, keepdim, **kw):
    ax = axis_arg(axis)
    if ax is None:
        if keepdim:
            return fn(a, dim=tuple(range(a.dim())), keepdim=True, **kw)
        return fn(a, **kw)
    return fn(a, dim=ax, keepdim=keepdim, **kw)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    a, = amp("sum", tt(x))
    return wrap(_reduce(torch.sum, a, axis, keepdim,
                        dtype=dtypes.convert_dtype(dtype)))


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return wrap(_reduce(torch.nansum, tt(x), axis, keepdim,
                        dtype=dtypes.convert_dtype(dtype)))


def mean(x, axis=None, keepdim=False, name=None):
    a, = amp("mean", tt(x))
    return wrap(_reduce(torch.mean, float_of(a), axis, keepdim))


def nanmean(x, axis=None, keepdim=False, name=None):
    return wrap(_reduce(torch.nanmean, float_of(tt(x)), axis, keepdim))


def max(x, axis=None, keepdim=False, name=None):
    return wrap(_reduce(torch.amax, tt(x), axis, keepdim))


def min(x, axis=None, keepdim=False, name=None):
    return wrap(_reduce(torch.amin, tt(x), axis, keepdim))


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    a = tt(x)
    d = dtypes.convert_dtype(dtype)
    if d is not None:
        a = a.to(d)
    dims = all_dims(a, axis)
    dims = (dims,) if isinstance(dims, int) else dims
    for ax in sorted((d % builtins.max(a.dim(), 1) for d in dims),
                     reverse=True):
        a = torch.prod(a, dim=ax, keepdim=keepdim)
    return wrap(a)


def logsumexp(x, axis=None, keepdim=False, name=None):
    a, = amp("logsumexp", tt(x))
    return wrap(torch.logsumexp(a, dim=all_dims(a, axis), keepdim=keepdim))


def cumsum(x, axis=None, dtype=None, name=None):
    a, = amp("cumsum", tt(x))
    d = dtypes.convert_dtype(dtype)
    if axis is None:
        return wrap(torch.cumsum(a.reshape(-1), 0, dtype=d))
    return wrap(torch.cumsum(a, int(axis), dtype=d))


def cumprod(x, dim=None, dtype=None, name=None):
    a = tt(x)
    d = dtypes.convert_dtype(dtype)
    if dim is None:
        return wrap(torch.cumprod(a.reshape(-1), 0, dtype=d))
    return wrap(torch.cumprod(a, int(dim), dtype=d))


def clip(x, min=None, max=None, name=None):
    return wrap(torch.clamp(tt(x), scalar(min), scalar(max)))


def _pairwise(fn):
    def op(x, y, name=None):
        return wrap(fn(*_tensor_pair(x, y)))
    op.__name__ = op.__qualname__ = fn.__name__
    return op


maximum = _pairwise(torch.maximum)
minimum = _pairwise(torch.minimum)
fmax = _pairwise(torch.fmax)
fmin = _pairwise(torch.fmin)
gcd = _pairwise(torch.gcd)
lcm = _pairwise(torch.lcm)
kron = _pairwise(torch.kron)


def add_n(inputs, name=None):
    if type(inputs) is Tensor:
        return inputs
    ts = [tt(i) for i in inputs]
    return wrap(torch.stack(ts).sum(0) if len(ts) > 1 else ts[0])


def multiplex(inputs, index, name=None):
    stacked = torch.stack([tt(i) for i in inputs])
    rows = tt(index).reshape(-1).long()
    return wrap(stacked[rows, torch.arange(stacked.shape[1],
                                           device=stacked.device)])


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return wrap(torch.nan_to_num(tt(x), nan=nan, posinf=posinf,
                                 neginf=neginf))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return wrap(torch.diagonal(tt(x), offset, axis1, axis2).sum(-1))


def all(x, axis=None, keepdim=False, name=None):
    return wrap(_reduce(torch.all, tt(x), axis, keepdim))


def any(x, axis=None, keepdim=False, name=None):
    return wrap(_reduce(torch.any, tt(x), axis, keepdim))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    a = tt(x)
    dims = all_dims(a, axis)
    out = torch.count_nonzero(a, dim=dims)
    if keepdim:
        for ax in sorted(d % a.dim() for d in (
                dims if isinstance(dims, tuple) else (dims,))):
            out = out.unsqueeze(ax)
    return wrap(out)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def lerp(x, y, weight, name=None):
    a, b = _tensor_pair(x, y)
    w = arg(weight)
    return wrap(a + w * (b - a))


def rad2deg(x, name=None):
    return wrap(torch.rad2deg(float_of(tt(x))))


def deg2rad(x, name=None):
    return wrap(torch.deg2rad(float_of(tt(x))))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    a = tt(x)
    pre = None if prepend is None else like(prepend, a)
    app = None if append is None else like(append, a)
    return wrap(torch.diff(a, n=n, dim=axis, prepend=pre, append=app))
