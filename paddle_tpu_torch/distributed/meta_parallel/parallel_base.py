"""``TensorParallel`` and ``ShardingParallel`` wrappers.

Counterpart of ``paddle_tpu/distributed/meta_parallel/parallel_base.py``.
The JAX wrappers stamp a replicated ``PartitionSpec`` on every
unannotated parameter and let ``jax.device_put`` lay them out. The
port's wrappers lay the model on the hybrid mesh
(``spmd.apply_param_shardings``) and then broadcast, as the Paddle
engines do at wrap: every parameter from the first rank of its dp group
over dp, and each parameter that mp does not shard from the first rank
of its mp group over mp (``TensorParallel``); every parameter over the
sharding and dp groups and each one mp does not shard over mp
(``ShardingParallel``, whose optimizer slots
``TrainStep(zero_axis="sharding")`` shards, beside mp too). Ranks that
built the model from one seed already agree; the broadcast makes any
model agree. ``PipelineParallel`` (``pipeline_parallel.py``) shares the
base; without a topology it lays nothing out.

State-dict names and ``parameters()`` are the wrapped model's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..collective import broadcast
from ..spmd import apply_param_shardings
from ...nn.layer import Layer

__all__ = ["TensorParallel", "ShardingParallel"]


@torch.no_grad()
def _broadcast(layer: nn.Module, group, skip_axis=None) -> None:
    if group is None or group.nranks <= 1:
        return
    for p in layer.parameters():
        if skip_axis is not None and any(
                skip_axis in axes
                for axes in getattr(p, "_dist_layout", {}).values()):
            continue
        broadcast(p.data, group.ranks[0], group)


class _MetaParallelBase(Layer):
    def __init__(self, layers: nn.Module, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        if hcg is not None:
            apply_param_shardings(layers, hcg.mesh)
        self._prepare()

    def _prepare(self) -> None:
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict


class TensorParallel(_MetaParallelBase):
    """mp-sharded parameters stay each rank's block; the rest agree."""

    def _prepare(self) -> None:
        hcg = self._hcg
        _broadcast(self._layers, hcg.get_data_parallel_group())
        _broadcast(self._layers, hcg.get_model_parallel_group(),
                   skip_axis="mp")


class ShardingParallel(_MetaParallelBase):
    """ZeRO: the parameters replicated over sharding and dp; the
    optimizer's slots are sharded by ``TrainStep(zero_axis=...)``."""

    def _prepare(self) -> None:
        hcg = self._hcg
        _broadcast(self._layers, hcg.get_sharding_parallel_group())
        _broadcast(self._layers, hcg.get_data_parallel_group())
        _broadcast(self._layers, hcg.get_model_parallel_group(),
                   skip_axis="mp")
