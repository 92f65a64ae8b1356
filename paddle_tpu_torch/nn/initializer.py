"""Parameter initializers: counterpart of ``paddle_tpu/nn/initializer.py``
(:25-202).

Each initializer is a callable ``(shape, dtype=None, device=None,
generator=None) -> tensor``. The JAX ones draw from the global RNG; here
a random initializer draws from the ``torch.Generator`` it is given (a
layer's ``reset_parameters`` passes the model's, so a model still
initialises in one pass from one seed), and from a generator seeded 0
on the tensor's device without one. The fans, gains, bounds and
layouts are the JAX module's: a conv kernel is ``[out, in, *k]``, a
linear weight ``[in, out]`` (its fans are ``shape[0]`` and
``shape[1]``). ``TruncatedNormal`` cuts at two standard deviations, as
``jax.random.truncated_normal(-2, 2)`` does.

``ParamAttr`` and ``_resolve_attr`` are the JAX surface for a layer's
``weight_attr`` / ``bias_attr``: ``False`` (no parameter), ``None`` (the
layer's default initializer), an ``Initializer``, a name or a
``ParamAttr`` (its initializer, ``trainable`` and ``learning_rate``,
which lands in the parameter's ``optimize_attr`` as in JAX).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain", "ParamAttr",
]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(np.dtype(dtype)))


def _gen(generator, device) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=torch.device(device or "cpu"))
    g.manual_seed(0)
    return g


class Initializer:
    def __call__(self, shape, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def _empty(self, shape, dtype, device):
        return torch.empty(tuple(shape), dtype=_dtype(dtype), device=device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t = self._empty(shape, dtype, device)
        return t.normal_(0.0, 1.0, generator=_gen(generator, device)) \
            * self.std + self.mean


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t = self._empty(shape, dtype, device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=_gen(generator, device))
        return t * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t = self._empty(shape, dtype, device)
        return t.uniform_(self.low, self.high,
                          generator=_gen(generator, device))


class XavierNormal(Initializer):
    def __init__(self, gain=1.0, fan_in=None, fan_out=None):
        self.gain, self.fan_in, self.fan_out = gain, fan_in, fan_out

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device, generator)


class XavierUniform(Initializer):
    def __init__(self, gain=1.0, fan_in=None, fan_out=None):
        self.gain, self.fan_in, self.fan_out = gain, fan_in, fan_out

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        std = calculate_gain(self.nonlinearity, self.slope) / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        limit = calculate_gain(self.nonlinearity, self.slope) \
            * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        v = self.value
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"Assign shape {arr.shape} != param shape "
                             f"{tuple(shape)}")
        return torch.tensor(arr, dtype=_dtype(dtype), device=device)


class Orthogonal(Initializer):
    """An orthogonal matrix (rows or columns orthonormal, times ``gain``)
    over the first dimension against the rest flattened."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t = self._empty(shape, dtype, device)
        return torch.nn.init.orthogonal_(t, self.gain,
                                         generator=_gen(generator, device))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None, generator=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i, *centers)] = 1.0
        return torch.tensor(out, dtype=_dtype(dtype), device=device)


# paddle.ParamAttr analogue ---------------------------------------------------
class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _resolve_attr(attr, default_init):
    """Normalise a param_attr/bias_attr argument to (initializer,
    trainable, name), or None for ``False`` (no parameter)."""
    if attr is False:
        return None
    if attr is None:
        return (default_init, True, None)
    if isinstance(attr, ParamAttr):
        return (attr.initializer or default_init, attr.trainable, attr.name)
    if isinstance(attr, Initializer):
        return (attr, True, None)
    if isinstance(attr, str):
        return (default_init, True, attr)
    raise TypeError(f"Unsupported param attr: {attr!r}")


def make_param(shape, attr, device=None):
    """A float32 zeros ``Parameter`` for ``attr`` (None for ``False``)
    carrying what ``attr`` asked for: its explicit initializer (applied
    now and by :func:`reinit`; None when the layer's default applies),
    ``trainable`` as ``requires_grad``, and ``optimize_attr`` /
    ``regularizer`` from a ``ParamAttr``."""
    resolved = _resolve_attr(attr, None)
    if resolved is None:
        return None
    init, trainable, _ = resolved
    p = torch.nn.Parameter(torch.zeros(tuple(shape), dtype=torch.float32,
                                       device=device),
                           requires_grad=bool(trainable))
    p._initializer = init
    p.optimize_attr = {"learning_rate": attr.learning_rate
                       if isinstance(attr, ParamAttr) else 1.0}
    p.regularizer = attr.regularizer if isinstance(attr, ParamAttr) \
        else None
    if init is not None:
        reinit(p, None, None)
    return p


@torch.no_grad()
def reinit(p, generator, default) -> None:
    """Fill ``p`` in place from its explicit initializer, else from
    ``default`` (a callable ``(p, generator)``; None leaves ``p``)."""
    if p is None:
        return
    init = getattr(p, "_initializer", None)
    if init is not None:
        p.copy_(init(p.shape, p.dtype, p.device, generator))
    elif default is not None:
        default(p, generator)
