"""Tensor-parallel layers: vocab-, column- and row-sharded modules.

Counterpart of ``paddle_tpu/distributed/meta_parallel/parallel_layers/
mp_layers.py``. The JAX layers hold the full logical parameter with a
``PartitionSpec`` and GSPMD inserts the collectives; the port's layers
hold the same full parameter with the same ``.spec`` until
``spmd.apply_param_shardings`` cuts it to the rank's block, then insert
the collectives themselves, as Megatron-LM writes them, through two
autograd pairs over the mp group:

- :func:`copy_to_model_parallel`: the identity forward, an all-reduce
  of the gradient in the backward (the input of a column-parallel
  product, whose every rank's share of the gradient sums to it);
- :func:`reduce_from_model_parallel`: an all-reduce forward, the
  identity backward (after a row-parallel product, a vocab-sharded
  lookup).

Without a mesh, or with an mp axis of one rank, every layer is its dense
counterpart and no collective runs.

:class:`ParallelCrossEntropy` over logits ``[..., V/mp]`` (a rank's vocab
block) is the vocab-parallel loss of ``c_softmax_with_cross_entropy``:
the max and the sum of exponentials all-reduced over mp, the target
logit taken from the rank that owns it (zero elsewhere) and
all-reduced, and a gradient ``softmax - onehot`` on the rank's own
block. Under an mp mesh the JAX layer composes the same dense ``lse -
tgt`` (never the chunked kernel, ``:152-168``); without one (or at mp =
1) it keeps the single-device branch: the streamed chunked loss
(``nn.chunked_ce.hard_nll``, the chunked-CE kernels on the card) at a
vocab of ``CHUNKED_CE_THRESHOLD`` or more, the dense float32 ``lse -
tgt`` below it.

Which branch runs is decided by the logits, not by the process's mesh:
a layer whose output is a rank's block of its last dimension (GPT's
tied head on an mp group, ``ColumnParallelLinear(gather_output=False)``)
marks it with its group (:func:`mark_mp_block`), and the loss takes the
vocab-parallel branch over a marked block or over logits it is told are
one (``ParallelCrossEntropy(mp_group=...)``, for a block sliced or cast
after the head, which loses the mark). Whole logits take the
single-device branch whatever mesh is active.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ....nn import functional as F
from ... import env
from ...spmd import P, apply_param_shardings

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "split",
           "copy_to_model_parallel", "reduce_from_model_parallel",
           "vocab_parallel_embedding", "parallel_cross_entropy",
           "token_cross_entropy", "mp_group_of", "MPModule",
           "mark_mp_block", "mp_block_group"]

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
    from ...collective import all_reduce
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
        from ...collective import all_gather
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
        from ...collective import all_gather
        blocks = all_gather(g.contiguous(), group=ctx.group)
        return torch.cat(list(blocks.unbind(0)), -1), None


def copy_to_model_parallel(x, group):
    return x if group is None else _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x, group):
    return x if group is None else _ReduceFromModelParallel.apply(x, group)


def vocab_parallel_embedding(ids, weight, v0: int, group):
    """Rows of a vocab-sharded table: ``weight`` holds rows ``v0 ..
    v0 + V/mp - 1``; ids outside them look up row 0 and are zeroed, and
    the blocks are summed over ``group``."""
    if group is None:
        return F.embedding(ids, weight)
    outside = (ids < v0) | (ids >= v0 + weight.shape[0])
    local = torch.where(outside, 0, ids - v0)
    out = F.embedding(local, weight)
    out = out.masked_fill(outside[..., None], 0.0)
    return reduce_from_model_parallel(out, group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, ids, group, v0):
        from ...collective import ReduceOp, all_reduce
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


def token_cross_entropy(logits, ids):
    """The single-device per-token loss (float32): the chunked loss at a
    large vocab, the dense ``lse - tgt`` with a detached max below."""
    from ....nn.chunked_ce import enabled_for, hard_nll
    if enabled_for(logits.shape[-1]):
        return hard_nll(logits, ids)
    lg32 = logits.float()
    z = lg32 - lg32.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(z), dim=-1))
    return lse - z.gather(-1, ids[..., None])[..., 0]


def _device(device):
    from ....core.device import resolve_device
    return resolve_device(device)


class MPModule(nn.Module):
    """A module that learns its mp group (None without one) and rank
    from ``spmd.apply_param_shardings`` (``_on_mesh``)."""

    mp_group = None
    mp_rank = 0

    def _on_mesh(self, mesh) -> None:
        self.mp_group = mp_group_of(mesh)
        self.mp_rank = mesh.axis_rank(MP_AXIS) if self.mp_group else 0


class VocabParallelEmbedding(MPModule):
    """An embedding whose table ``[V, E]`` is sharded over mp by vocab
    rows (N(0, 0.02), the JAX default)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=_device(device)))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
        self.weight.spec = P(MP_AXIS, None)
        self.weight.is_distributed = True

    def forward(self, x):
        return vocab_parallel_embedding(
            x, self.weight, self.mp_rank * self.weight.shape[0], self.mp_group)


def _xavier(w, generator):
    fan_in, fan_out = w.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


class ColumnParallelLinear(MPModule):
    """``x @ W + b`` with ``W [in, out]`` and ``b`` sharded on ``out``;
    ``gather_output`` all-gathers the output's last dimension, else each
    rank keeps its block."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 mp_group=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = _device(device)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=dev))
        _xavier(self.weight, generator)
        self.weight.spec = P(None, MP_AXIS)
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev))
            self.bias.spec = P(MP_AXIS)
            self.bias.is_distributed = True

    def forward(self, x):
        y = F.linear(copy_to_model_parallel(x, self.mp_group), self.weight,
                     self.bias)
        if self.gather_output and self.mp_group is not None:
            return _GatherFromModelParallel.apply(y, self.mp_group)
        return mark_mp_block(y, self.mp_group)


class RowParallelLinear(MPModule):
    """``x @ W + b`` with ``W [in, out]`` sharded on ``in``: the partial
    products are all-reduced over mp, then the replicated bias is added.
    ``input_is_parallel`` takes x already split on its last dimension
    (a column-parallel layer's ungathered output)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 mp_group=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = _device(device)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=dev))
        _xavier(self.weight, generator)
        self.weight.spec = P(MP_AXIS, None)
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev))
            self.bias.spec = P()

    def forward(self, x):
        if self.mp_group is not None and not self.input_is_parallel:
            x = _ScatterToModelParallel.apply(x, self.mp_group)
        y = reduce_from_model_parallel(F.linear(x, self.weight), self.mp_group)
        return y if self.bias is None else y + self.bias


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross entropy ``[..., 1]`` (float32). Over a
    rank's vocab block (logits marked by the layer that made them, or
    any logits when ``mp_group`` is given) the vocab-parallel loss, the
    block starting at class ``group.rank * width``; over whole logits
    the single-device loss (see the module's docstring)."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()
        self.mp_group = mp_group

    def forward(self, logits, label):
        ids = label.long()
        if ids.dim() == logits.dim():
            ids = ids.squeeze(-1)
        marked = mp_block_group(logits)
        group = self.mp_group if self.mp_group is not None else marked
        if marked is not None and group is not marked:
            raise ValueError(
                "ParallelCrossEntropy: the logits are a block over another "
                "model-parallel group than the mp_group it was given")
        if group is None:
            if mp_group_of() is not None and ids.numel() and \
                    int(ids.max()) >= logits.shape[-1]:
                # an mp mesh is active and the labels run past the
                # logits: a vocab block that lost its mark
                raise ValueError(
                    f"ParallelCrossEntropy: labels reach class "
                    f"{int(ids.max())} but the logits hold "
                    f"{logits.shape[-1]}; a rank's vocab block that no "
                    "longer carries its group (sliced or cast after the "
                    "head) needs ParallelCrossEntropy(mp_group=...)")
            return token_cross_entropy(logits, ids)[..., None]
        v0 = group.rank * logits.shape[-1]
        return parallel_cross_entropy(logits, ids, group, v0)[..., None]


def split(x, size, operation: str, axis: int = 0, gather_out: bool = True,
          weight_attr=None, bias_attr=None, name=None):
    """Build a sharded embedding or linear of ``size`` on x's device,
    lay it on the active mesh and apply it to ``x`` (the JAX
    ``paddle.distributed.split``)."""
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1], device=x.device)
    elif operation == "linear" and axis == 0:
        layer = RowParallelLinear(size[0], size[1],
                                  has_bias=bias_attr is not False,
                                  device=x.device)
    elif operation == "linear":
        layer = ColumnParallelLinear(size[0], size[1],
                                     has_bias=bias_attr is not False,
                                     gather_output=gather_out,
                                     device=x.device)
    else:
        raise ValueError(f"unknown split operation {operation!r}")
    if env.get_mesh() is not None:
        apply_param_shardings(layer)
    return layer(x)
