"""Random ops: counterpart of ``paddle_tpu/tensor/random.py``.

Every draw takes an explicit ``torch.Generator``: the one of its device
that ``core.random.random_generator`` keeps (reseeded by
``paddle.seed``), or one seeded with ``seed`` where the op takes one.
The numbers differ from the JAX package's (``rbg`` keys); the shapes,
dtypes, ranges and the determinism under ``paddle.seed`` do not. The
in-place ``uniform_`` / ``normal_`` / ``exponential_`` rebind the facade.
"""

from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.random import random_generator
from ._base import dt, ints, tt, wrap

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "standard_normal", "bernoulli", "multinomial", "poisson",
    "uniform_", "normal_", "exponential_",
]


def _gen(device, seed=0) -> torch.Generator:
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return random_generator(device)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = resolve_device(None)
    return wrap(torch.randn(ints(shape), dtype=dt(dtype), device=dev,
                            generator=_gen(dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if hasattr(mean, "shape") or hasattr(std, "shape"):
        m = tt(mean) if hasattr(mean, "shape") else mean
        s = tt(std) if hasattr(std, "shape") else std
        ref = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(getattr(m, "shape", ()),
                                     getattr(s, "shape", ()))
        z = torch.randn(shp, dtype=ref.dtype, device=ref.device,
                        generator=_gen(ref.device))
        return wrap(z * s + m)
    dev = resolve_device(None)
    z = torch.randn(ints(shape or [1]), dtype=dtypes.get_default_dtype(),
                    device=dev, generator=_gen(dev))
    return wrap(z * std + mean)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device(None)
    u = torch.rand(ints(shape), dtype=dt(dtype), device=dev,
                   generator=_gen(dev, seed))
    return wrap(u * (max - min) + min)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device(None)
    return wrap(torch.randint(int(low), int(high), ints(shape),
                              dtype=dtypes.convert_dtype(dtype or "int64"),
                              device=dev, generator=_gen(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, shape=tuple(tt(x).shape),
                   dtype=dtype or "int64")


def randperm(n, dtype="int64", name=None):
    dev = resolve_device(None)
    return wrap(torch.randperm(int(n), dtype=dtypes.convert_dtype(dtype),
                               device=dev, generator=_gen(dev)))


def bernoulli(x, name=None):
    p = tt(x)
    return wrap(torch.bernoulli(p, generator=_gen(p.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = tt(x)
    return wrap(torch.multinomial(p, num_samples, replacement=replacement,
                                  generator=_gen(p.device)))


def poisson(x, name=None):
    lam = tt(x)
    return wrap(torch.poisson(lam, generator=_gen(lam.device)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    a = tt(x)
    u = torch.rand(a.shape, dtype=a.dtype, device=a.device,
                   generator=_gen(a.device, seed))
    x._rebind(u * (max - min) + min)
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    a = tt(x)
    z = torch.randn(a.shape, dtype=a.dtype, device=a.device,
                    generator=_gen(a.device))
    x._rebind(z * std + mean)
    return x


def exponential_(x, lam=1.0, name=None):
    a = tt(x)
    e = torch.empty_like(a).exponential_(1.0, generator=_gen(a.device))
    x._rebind(e / lam)
    return x
