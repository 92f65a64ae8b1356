"""Statistics: counterpart of ``paddle_tpu/tensor/stat.py``. ``median``
averages the two middle values of an even count (``jnp.median``), as
``torch.quantile(0.5)`` does; ``torch.median`` would take the lower."""

from __future__ import annotations

import torch

from ._base import all_dims, axis_arg, float_of, like, tt, wrap

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile"]

from .math import mean  # noqa: E402,F401


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    a = float_of(tt(x))
    return wrap(torch.std(a, dim=all_dims(a, axis),
                          correction=1 if unbiased else 0, keepdim=keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    a = float_of(tt(x))
    return wrap(torch.var(a, dim=all_dims(a, axis),
                          correction=1 if unbiased else 0, keepdim=keepdim))


def _quantile(fn, a, q, axis, keepdim):
    """``fn`` (torch.quantile or nanquantile) over one axis, several
    (moved last and flattened) or all."""
    a = float_of(a)
    # a scalar q gives no quantile dimension (a 0-d tensor q would)
    qt = float(q) if isinstance(q, (int, float)) else like(q, a).to(a.dtype)
    nq = not isinstance(qt, float)
    ax = axis_arg(axis)
    if ax is None:
        out = fn(a.reshape(-1), qt, dim=0)
        if keepdim:
            out = out.reshape(tuple(out.shape) + (1,) * a.dim())
        return out
    if isinstance(ax, int):
        return fn(a, qt, dim=ax, keepdim=keepdim)
    dims = sorted(d % a.dim() for d in ax)
    rest = [d for d in range(a.dim()) if d not in dims]
    flat = a.permute(rest + dims).reshape(
        [a.shape[d] for d in rest] + [-1])
    out = fn(flat, qt, dim=-1)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d + (1 if nq else 0))
    return out


def median(x, axis=None, keepdim=False, name=None):
    return wrap(_quantile(torch.quantile, tt(x), 0.5, axis, keepdim))


def nanmedian(x, axis=None, keepdim=False, name=None):
    return wrap(_quantile(torch.nanquantile, tt(x), 0.5, axis, keepdim))


def quantile(x, q, axis=None, keepdim=False, name=None):
    return wrap(_quantile(torch.quantile, tt(x), q, axis, keepdim))


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return wrap(_quantile(torch.nanquantile, tt(x), q, axis, keepdim))
