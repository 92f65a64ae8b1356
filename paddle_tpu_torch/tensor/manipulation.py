"""Shape and layout ops: counterpart of
``paddle_tpu/tensor/manipulation.py``.

Paddle's meanings, not torch's: ``split(x, 2)`` cuts two sections,
``transpose(x, perm)`` permutes, ``gather`` / ``index_select`` take
``(x, index, axis)``. ``unique`` and ``unique_consecutive`` go through
the host, as in the JAX package.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.tensor import Tensor
from ._base import dt, ints, like, scalar, tt, wrap

__all__ = [
    "reshape", "flatten", "transpose", "squeeze", "unsqueeze", "concat",
    "stack", "unstack", "split", "chunk", "tile", "expand", "expand_as",
    "broadcast_to", "gather", "gather_nd", "scatter", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "take_along_axis",
    "put_along_axis", "roll", "flip", "rot90", "unique", "unique_consecutive",
    "unbind", "slice", "strided_slice", "crop", "pad", "shard_index",
    "repeat_interleave", "moveaxis", "as_complex", "as_real", "tensordot",
    "tolist", "cast",
]


def cast(x, dtype):
    return wrap(tt(x).to(dt(dtype)))


def reshape(x, shape, name=None):
    return wrap(tt(x).reshape(ints(shape)))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    a = tt(x)
    if a.dim() == 0:
        return wrap(a.reshape(1))
    return wrap(torch.flatten(a, start_axis, stop_axis))


def transpose(x, perm, name=None):
    return wrap(tt(x).permute(ints(perm)))


def moveaxis(x, source, destination, name=None):
    return wrap(torch.movedim(tt(x), source, destination))


def squeeze(x, axis=None, name=None):
    a = tt(x)
    if axis is None:
        return wrap(torch.squeeze(a))
    return wrap(torch.squeeze(a, ints(axis)))


def unsqueeze(x, axis, name=None):
    out = tt(x)
    for ax in sorted(ints(axis)):
        out = out.unsqueeze(ax)
    return wrap(out)


def _axis(axis) -> int:
    return int(scalar(axis))


def concat(x, axis=0, name=None):
    ts = [tt(i) for i in x]
    return wrap(torch.cat(ts, _axis(axis)))


def stack(x, axis=0, name=None):
    return wrap(torch.stack([tt(i) for i in x], int(axis)))


def unstack(x, axis=0, num=None, name=None):
    return [wrap(o) for o in torch.unbind(tt(x), int(axis))]


def unbind(x, axis=0):
    return unstack(x, axis)


def split(x, num_or_sections, axis=0, name=None):
    a = tt(x)
    ax = _axis(axis)
    dim = a.shape[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(scalar(s)) for s in num_or_sections]
        if builtins.any(s < 0 for s in sizes):
            rest = dim - builtins.sum(s for s in sizes if s >= 0)
            sizes = [rest if s < 0 else s for s in sizes]
    outs, off = [], 0
    for s in sizes:
        outs.append(wrap(a.narrow(ax, off, s)))
        off += s
    return outs


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    return wrap(torch.tile(tt(x), ints(repeat_times)))


def expand(x, shape, name=None):
    a = tt(x)
    tgt = list(ints(shape))
    off = len(tgt) - a.dim()
    for i, s in enumerate(tgt):
        if s == -1:
            tgt[i] = a.shape[i - off]
    return wrap(a.broadcast_to(tgt))


def expand_as(x, y, name=None):
    return wrap(tt(x).broadcast_to(tt(y).shape))


def broadcast_to(x, shape, name=None):
    return wrap(tt(x).broadcast_to(ints(shape)))


def gather(x, index, axis=0, name=None):
    a = tt(x)
    return wrap(torch.index_select(a, _axis(axis),
                                   like(index, a).reshape(-1).long()))


def gather_nd(x, index, name=None):
    a = tt(x)
    idx = like(index, a).long()
    return wrap(a[tuple(idx[..., i] for i in range(idx.shape[-1]))])


def scatter(x, index, updates, overwrite=True, name=None):
    a = tt(x)
    i = like(index, a).reshape(-1).long()
    u = like(updates, a).to(a.dtype)
    if overwrite:
        return wrap(a.index_put((i,), u))
    base = a.index_put((i,), torch.zeros_like(u))
    return wrap(base.index_add(0, i, u))


def scatter_nd_add(x, index, updates, name=None):
    a = tt(x)
    idx = like(index, a).long()
    k = idx.shape[-1]
    flat = idx.reshape(-1, k)
    u = like(updates, a).to(a.dtype).reshape((-1,) + tuple(a.shape[k:]))
    return wrap(a.index_put(tuple(flat[:, i] for i in range(k)), u,
                            accumulate=True))


def scatter_nd(index, updates, shape, name=None):
    u = tt(updates)
    base = torch.zeros(ints(shape), dtype=u.dtype, device=u.device)
    return scatter_nd_add(base, index, u)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index, name=None):
    a = tt(x)
    return wrap(torch.gather(a, 1, like(index, a).long()))


def take_along_axis(arr, indices, axis, name=None):
    a = tt(arr)
    return wrap(torch.gather(a, int(axis), like(indices, a).long()))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    a = tt(arr)
    i = like(indices, a).long()
    v = like(values, a).to(a.dtype).broadcast_to(i.shape)
    if reduce == "add":
        return wrap(a.scatter_add(int(axis), i, v))
    if reduce in ("multiply", "mul"):
        return wrap(a.scatter_reduce(int(axis), i, v, "prod"))
    return wrap(a.scatter(int(axis), i, v))


def roll(x, shifts, axis=None, name=None):
    a = tt(x)
    if axis is None:
        return wrap(torch.roll(a, shifts))
    return wrap(torch.roll(a, shifts, axis))


def flip(x, axis, name=None):
    return wrap(torch.flip(tt(x), ints(axis)))


def rot90(x, k=1, axes=(0, 1), name=None):
    return wrap(torch.rot90(tt(x), k, list(axes)))


def _host(x):
    a = tt(x)
    return a, a.detach().cpu().numpy()


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    a, arr = _host(x)
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return wrap(torch.from_numpy(res).to(a.device))
    return tuple(wrap(torch.from_numpy(np.asarray(r)).to(a.device))
                 for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    t, arr = _host(x)
    if axis is None:
        arr = arr.reshape(-1)
    a = arr if axis is None else np.moveaxis(arr, axis, 0)
    keep = np.ones(a.shape[0], dtype=bool)
    for i in range(1, a.shape[0]):
        keep[i] = not np.array_equal(a[i], a[i - 1])
    out = a[keep]
    outs = [out if axis is None else np.moveaxis(out, 0, axis)]
    if return_inverse:
        outs.append((np.cumsum(keep) - 1).astype(np.int64))
    if return_counts:
        idx = np.flatnonzero(keep)
        outs.append(np.diff(np.append(idx, a.shape[0])).astype(np.int64))
    outs = [wrap(torch.from_numpy(np.ascontiguousarray(o)).to(t.device))
            for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def _range_index(n: int, s: int, e: int, st: int, device) -> torch.Tensor:
    return torch.tensor(range(*builtins.slice(s, e, st).indices(n)),
                        dtype=torch.long, device=device)


def slice(input, axes, starts, ends, name=None):
    a = tt(input)
    idx = [builtins.slice(None)] * a.dim()
    for ax, s, e in zip(ints(axes), ints(starts), ints(ends)):
        idx[ax] = builtins.slice(s, e)
    return wrap(a[tuple(idx)])


def strided_slice(x, axes, starts, ends, strides, name=None):
    a = tt(x)
    for ax, s, e, st in zip(ints(axes), ints(starts), ints(ends),
                            ints(strides)):
        if st > 0:
            idx = [builtins.slice(None)] * a.dim()
            idx[ax] = builtins.slice(s, e, st)
            a = a[tuple(idx)]
        else:
            # torch slices take no negative step: gather the positions
            a = a.index_select(ax, _range_index(a.shape[ax], s, e, st,
                                                a.device))
    return wrap(a)


def crop(x, shape=None, offsets=None, name=None):
    a = tt(x)
    shp = ints(shape)
    offs = ints(offsets) if offsets is not None else (0,) * len(shp)
    return wrap(a[tuple(builtins.slice(o, o + s)
                        for o, s in zip(offs, shp))])


_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's ``pad`` (the JAX ``nn.functional.pad``): ``2 * ndim``
    entries pad every axis in order, fewer pad the innermost spatial
    axes (``left, right, top, bottom, ...``)."""
    a = tt(x)
    pad = [int(p) for p in (pad.tolist() if type(pad) is Tensor else pad)]
    if len(pad) == 2 * a.dim():
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(a.dim())]
    else:
        pairs = [(0, 0)] * a.dim()
        channel_last = data_format in ("NHWC", "NLC", "NDHWC")
        spatial = list(range(1, a.dim() - 1)) if channel_last \
            else list(range(2, a.dim()))
        for i in range(len(pad) // 2):
            pairs[spatial[len(spatial) - 1 - i]] = (pad[2 * i],
                                                    pad[2 * i + 1])
    flat = [p for pair in reversed(pairs) for p in pair]
    if mode == "constant":
        return wrap(TF.pad(a, flat, value=value))
    return wrap(TF.pad(a, flat, mode=_PAD_MODES[mode]))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = tt(input)
    size = index_num // nshards
    return wrap(torch.where(a // size == shard_id, a % size,
                            torch.full_like(a, ignore_value)))


def repeat_interleave(x, repeats, axis=None, name=None):
    a = tt(x)
    reps = like(repeats, a) if type(repeats) is Tensor else repeats
    return wrap(torch.repeat_interleave(a, reps, dim=axis))


def as_complex(x, name=None):
    a = tt(x)
    return wrap(torch.complex(a[..., 0], a[..., 1]))


def as_real(x, name=None):
    a = tt(x)
    return wrap(torch.stack([torch.real(a), torch.imag(a)], -1))


def tensordot(x, y, axes=2, name=None):
    a = tt(x)
    return wrap(torch.tensordot(a, like(y, a), dims=axes))


def tolist(x):
    return tt(x).tolist()
