"""Search and sort ops: counterpart of ``paddle_tpu/tensor/search.py``.

``sort`` returns the values alone and ``argmax`` / ``topk`` indices are
int64 (int32 in the JAX package, whose x64 is off). ``mode`` is the JAX
composition (the sorted values' longest run by its cumulative count),
so it picks the same value and index."""

from __future__ import annotations

import torch

from ._base import like, scalar, tt, wrap

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "index_sample", "masked_select", "where", "nonzero", "searchsorted",
    "bucketize",
]

from .logic import masked_select, nonzero, where  # noqa: E402,F401
from .manipulation import index_sample  # noqa: E402,F401


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return wrap(torch.argmax(tt(x), dim=axis, keepdim=keepdim))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return wrap(torch.argmin(tt(x), dim=axis, keepdim=keepdim))


def argsort(x, axis=-1, descending=False, name=None):
    return wrap(torch.argsort(tt(x), dim=axis, descending=descending,
                              stable=True))


def sort(x, axis=-1, descending=False, name=None):
    return wrap(torch.sort(tt(x), dim=axis, descending=descending,
                           stable=True).values)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    vals, idx = torch.topk(tt(x), int(scalar(k)),
                           dim=-1 if axis is None else axis,
                           largest=largest, sorted=sorted)
    return wrap(vals), wrap(idx)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    a = tt(x)
    idx = torch.argsort(a, dim=axis, stable=True).narrow(axis, k - 1, 1)
    vals = torch.gather(a, axis, idx)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return wrap(vals), wrap(idx)


def mode(x, axis=-1, keepdim=False, name=None):
    a = tt(x)
    srt, idx = torch.sort(a, dim=axis, stable=True)
    same = torch.cat([torch.ones_like(srt.narrow(axis, 0, 1),
                                      dtype=torch.int32),
                      (torch.diff(srt, dim=axis) == 0).int()], axis)
    runs = torch.cumsum(same, axis) * same
    pos = torch.argmax(runs, dim=axis, keepdim=True)
    vals = torch.gather(srt, axis, pos)
    inds = torch.gather(idx, axis, pos)
    if not keepdim:
        vals, inds = vals.squeeze(axis), inds.squeeze(axis)
    return wrap(vals), wrap(inds)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = tt(sorted_sequence)
    return wrap(torch.searchsorted(seq, like(values, seq), right=right,
                                   out_int32=out_int32))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)
