"""The Megatron-LM collectives of tensor parallelism, below ``nn``.

The autograd pairs over an mp group that the tensor-parallel layers
(``meta_parallel.parallel_layers.mp_layers``), the encoder layers of
``nn.layers`` and the models insert where GSPMD would:

- :func:`copy_to_model_parallel`: the identity forward, an all-reduce
  of the gradient in the backward (the input of a column-parallel
  product, whose every rank's share of the gradient sums to it);
- :func:`reduce_from_model_parallel`: an all-reduce forward, the
  identity backward (after a row-parallel product, a vocab-sharded
  lookup);
- :func:`scatter_to_model_parallel`: the rank's block of the last
  dimension forward, an all-gather of the gradient backward.

A tensor that is this rank's block of its last dimension (a
tensor-parallel head's logits) carries its group
(:func:`mark_mp_block`), and :func:`parallel_cross_entropy` is the
vocab-parallel loss over such a block. :class:`MPModule` learns its mp
group from ``spmd.apply_param_shardings``. This module imports torch and
the collectives only, never ``nn``.
"""

from __future__ import annotations

import torch

from . import env
from ..nn.layer import Layer

__all__ = ["MP_AXIS", "MPModule", "mp_group_of", "mark_mp_block",
           "mp_block_group", "copy_to_model_parallel",
           "reduce_from_model_parallel", "scatter_to_model_parallel",
           "gather_from_model_parallel", "parallel_cross_entropy"]

MP_AXIS = "mp"


def mp_group_of(mesh=None):
    """The mp group of ``mesh`` (default: the active mesh) when its mp
    axis has more than one rank, else None."""
    mesh = mesh if mesh is not None else env.get_mesh()
    if mesh is None or mesh.axis_size(MP_AXIS) <= 1:
        return None
    return mesh.group(MP_AXIS)


def mark_mp_block(t: torch.Tensor, group) -> torch.Tensor:
    """Mark ``t`` as this rank's block of its last dimension over
    ``group`` (None: nothing to mark); returns ``t``."""
    if group is not None:
        t._mp_block_group = group
    return t


def mp_block_group(t: torch.Tensor):
    """The group :func:`mark_mp_block` gave ``t``, else None."""
    return getattr(t, "_mp_block_group", None)


def _sum(t, group):
    from .collective import all_reduce
    return all_reduce(t, group=group)


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous().clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModelParallel(torch.autograd.Function):
    """All-gather the last dimension forward; the rank's slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        from .collective import all_gather
        ctx.group, ctx.n = group, x.shape[-1]
        blocks = all_gather(x.contiguous(), group=group)
        return torch.cat(list(blocks.unbind(0)), -1)

    @staticmethod
    def backward(ctx, g):
        r = ctx.group.rank
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


class _ScatterToModelParallel(torch.autograd.Function):
    """The rank's slice of the last dimension forward; an all-gather of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[-1] // group.nranks
        r = group.rank
        return x[..., r * n:(r + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        from .collective import all_gather
        blocks = all_gather(g.contiguous(), group=ctx.group)
        return torch.cat(list(blocks.unbind(0)), -1), None


def scatter_to_model_parallel(x, group):
    """This rank's block of x's last dimension over ``group`` (x itself
    without one); the backward all-gathers the blocks' gradients, so a
    replicated tensor gets its whole gradient on every rank."""
    return x if group is None else _ScatterToModelParallel.apply(x, group)


def gather_from_model_parallel(x, group):
    """The blocks of x's last dimension over ``group`` concatenated (x
    itself without one); the backward keeps the rank's slice."""
    return x if group is None else _GatherFromModelParallel.apply(x, group)


def copy_to_model_parallel(x, group):
    return x if group is None else _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x, group):
    return x if group is None else _ReduceFromModelParallel.apply(x, group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, ids, group, v0):
        from .collective import ReduceOp, all_reduce
        lg = logits.float()
        m = lg.max(-1).values
        all_reduce(m, ReduceOp.MAX, group)
        z = lg - m[..., None]
        e = torch.exp(z)
        s = e.sum(-1)
        all_reduce(s, group=group)
        outside = (ids < v0) | (ids >= v0 + lg.shape[-1])
        local = torch.where(outside, 0, ids - v0)
        tgt = z.gather(-1, local[..., None])[..., 0].masked_fill(outside, 0.0)
        all_reduce(tgt, group=group)
        ctx.save_for_backward(e, s, local, outside)
        ctx.dtype = logits.dtype
        return torch.log(s) - tgt

    @staticmethod
    def backward(ctx, g):
        e, s, local, outside = ctx.saved_tensors
        grad = e / s[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, local[..., None], (~outside).float()[..., None])
        grad = (grad - onehot) * g[..., None]
        return grad.to(ctx.dtype), None, None, None


def parallel_cross_entropy(logits, ids, group, v0: int):
    """Per-token loss ``lse - tgt`` (float32) over a rank's vocab block
    ``[..., V/mp]`` starting at class ``v0``."""
    return _VocabParallelCE.apply(logits, ids.long(), group, int(v0))


class MPModule(Layer):
    """A module that learns its mp group (None without one) and rank
    from ``spmd.apply_param_shardings`` (``_on_mesh``)."""

    mp_group = None
    mp_rank = 0

    def _on_mesh(self, mesh) -> None:
        self.mp_group = mp_group_of(mesh)
        self.mp_rank = mesh.axis_rank(MP_AXIS) if self.mp_group else 0
