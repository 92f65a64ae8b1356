"""Normalisation layers: counterpart of ``paddle_tpu/nn/layers/norm.py``.

``BatchNorm``, ``BatchNorm1D/2D/3D`` (``norm.py:20-64``): parameters
``weight`` (ones) and ``bias`` (zeros), or what ``weight_attr`` /
``bias_attr`` ask for (``nn.initializer``), buffers ``_mean`` (zeros)
and ``_variance`` (ones), the JAX names, momentum 0.9 on the old value;
``nn.functional.batch_norm`` does the arithmetic.

On a data-parallel mesh (``jit.TrainStep`` sets ``_data_groups``, the
mesh's data groups of more than one rank, on every batch norm of the
model) a training-mode forward takes its statistics over the global
batch, as the JAX step under GSPMD takes them
(``functional_vision._batch_norm_global``): every batch norm, synced or
not, since the JAX step never sets a data axis.

``SyncBatchNorm`` (``norm.py:70-136``) is that batch norm; while
``distributed.env.set_data_axis(name)`` names a mesh axis it runs the
JAX layer's own recipe over that axis's group instead: f32 means of
``a`` and ``a^2`` averaged over the group (a differentiable all-reduce),
``var = E[a^2] - mean^2``, ``(a - mean) * rsqrt(var + eps)`` in ``a``'s
dtype, then the affine. ``convert_sync_batchnorm`` swaps every batch
norm of a layer tree for one sharing its parameters and buffers."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..functional_vision import (_CHANNEL_LAST, _batch_norm_global,
                                 _from_channel_first, _to_channel_first,
                                 _update_running)
from ..initializer import make_param

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm"]


class LayerNorm(nn.Module):
    """``weight``/``bias`` over the last dim; float32 statistics, output
    in the input's dtype (``nn/functional.py:1014``)."""

    def __init__(self, size: int, device: Optional[torch.device] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self.eps)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        #: the data groups of a data-parallel mesh (``TrainStep`` sets
        #: them): the statistics of a training forward span their ranks
        self._data_groups = ()
        for name, attr, default in (("weight", weight_attr, 1.0),
                                    ("bias", bias_attr, 0.0)):
            p = make_param((num_features,), attr, device)
            if p is not None and p._initializer is None:
                p.data.fill_(default)
            self.register_parameter(name, p)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        if self._data_groups and self.training \
                and not self._use_global_stats:
            return _batch_norm_global(
                x, self._mean, self._variance, self.weight, self.bias,
                self._data_groups, self._momentum, self._epsilon,
                self._data_format)
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCL" if data_format == "NCL" else "NLC",
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, device=device)


class _MeanOver(torch.autograd.Function):
    """The mean of a tensor over a group's ranks (``jax.lax.pmean``), its
    gradient the mean of the ranks' cotangents (pmean's transpose)."""

    @staticmethod
    def forward(ctx, t, group):
        from ...distributed.collective import ReduceOp, all_reduce
        ctx.group = group
        return all_reduce(t.clone(), ReduceOp.AVG, group)

    @staticmethod
    def backward(ctx, g):
        from ...distributed.collective import ReduceOp, all_reduce
        return all_reduce(g.contiguous().clone(), ReduceOp.AVG,
                          ctx.group), None


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm (module docstring): plain
    :class:`BatchNorm` eagerly and under ``TrainStep``'s global
    statistics; the JAX recipe over the group of the mesh axis that
    ``distributed.env.set_data_axis`` names, in training mode."""

    def forward(self, x):
        from ...distributed import env as dist_env
        axis = dist_env.current_data_axis()
        if axis is None or not self.training:
            return super().forward(x)
        group = dist_env.get_mesh().group(axis)
        channel_last = self._data_format in _CHANNEL_LAST
        a = _to_channel_first(x, channel_last)
        red = [i for i in range(a.dim()) if i != 1]
        a32 = a.float()
        mean = _MeanOver.apply(a32.mean(red), group)
        sq = _MeanOver.apply(a32.square().mean(red), group)
        var = sq - mean.square()
        shape = (1, -1) + (1,) * (a.dim() - 2)
        out = (a - mean.view(shape).to(a.dtype)) \
            * torch.rsqrt(var.view(shape) + self._epsilon).to(a.dtype)
        if self.weight is not None:
            out = out * self.weight.view(shape)
        if self.bias is not None:
            out = out + self.bias.view(shape)
        _update_running(self._mean, self._variance, mean.detach(),
                        var.detach(), self._momentum)
        return _from_channel_first(out, channel_last)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every batch norm of ``layer``'s tree (``layer`` itself
        included) as a ``SyncBatchNorm`` sharing its parameters and
        buffers; returns the converted tree."""
        out = layer
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
            out._data_groups = layer._data_groups
            out.train(layer.training)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out
