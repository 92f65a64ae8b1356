"""Pipeline layer descriptions and stage segmentation.

Counterpart of ``paddle_tpu/distributed/meta_parallel/parallel_layers/
pp_layers.py``: :class:`LayerDesc` (deferred construction),
:class:`SharedLayerDesc` (a layer whose parameters several stages use,
the tied embedding), :class:`SegmentLayers` (``uniform`` or
``layer:<Name>`` boundaries) and :class:`PipelineLayer`.

The JAX package's single controller builds every stage. The port runs a
stage a process: under a fleet topology whose pp degree is the
layer's ``num_stages``, each rank builds only its own segment
(:meth:`PipelineLayer.stage` of another stage raises). A shared layer
is then built on every stage that uses it, broadcast from the lowest
such stage at construction, and its gradient summed over those stages
before the update (:meth:`PipelineLayer.allreduce_shared_weight_
gradients`, which ``PipelineParallel.train_batch`` calls). Without a pp
group one process builds and runs every stage, as the JAX controller
does, and the shared layer is one instance.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from ....nn.layer import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    """Deferred layer construction: class + ctor args, built per stage."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not callable(layer_func):
            raise TypeError("LayerDesc expects an nn.Module subclass or "
                            "callable")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        name = getattr(self.layer_func, "__name__", str(self.layer_func))
        return f"LayerDesc({name})"


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters are shared across stages (e.g. tied
    embedding/LM-head). All descs with the same ``key`` resolve to ONE
    built layer on a stage; ``forward_func`` customizes the call at
    reuse sites."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedCall(Layer):
    """Call-site wrapper around a shared layer instance."""

    def __init__(self, shared: nn.Module, forward_func: Optional[Callable]):
        super().__init__()
        # registered as a child only at the stage's first site; later
        # sites hold a plain reference so parameters are not counted twice
        object.__setattr__(self, "_shared_ref", shared)
        self._forward_func = forward_func

    def forward(self, *args, **kwargs):
        if self._forward_func is not None:
            return self._forward_func(self._shared_ref, *args, **kwargs)
        return self._shared_ref(*args, **kwargs)


class SegmentLayers:
    """Split a desc list into num_parts contiguous segments.

    method="uniform": equal layer counts. method="layer:<Name>": one
    boundary before each layer whose class name matches, mirroring the
    reference's seg_method="layer:TransformerBlock" style.
    """

    def __init__(self, layers_desc: Sequence, num_parts: int,
                 method: str = "uniform"):
        self.descs = list(layers_desc)
        self.num_parts = int(num_parts)
        self.method = method
        if len(self.descs) < self.num_parts:
            raise ValueError(
                f"{len(self.descs)} layers cannot fill {num_parts} stages")

    def do_segment(self) -> List[int]:
        n, parts = len(self.descs), self.num_parts
        if self.method == "uniform":
            base, rem = divmod(n, parts)
            bounds = [0]
            for i in range(parts):
                bounds.append(bounds[-1] + base + (1 if i < rem else 0))
            return bounds
        m = re.match(r"layer:(.+)", self.method)
        if m:
            name = m.group(1)
            marks = [i for i, d in enumerate(self.descs)
                     if self._desc_name(d) == name]
            if len(marks) < parts:
                raise ValueError(
                    f"only {len(marks)} '{name}' layers for {parts} stages")
            # distribute the matched layers evenly; boundary = first matched
            # layer of each chunk
            bounds = [0]
            base, rem = divmod(len(marks), parts)
            idx = 0
            for i in range(parts - 1):
                idx += base + (1 if i < rem else 0)
                bounds.append(marks[idx])
            bounds.append(n)
            return bounds
        raise ValueError(f"unknown seg method {self.method!r}")

    @staticmethod
    def _desc_name(d) -> str:
        if isinstance(d, LayerDesc):
            return getattr(d.layer_func, "__name__", "")
        return type(d).__name__


class PipelineLayer(Layer):
    """The whole network as an ordered desc list, segmented into stages
    (``stage_<s>`` children, each an ``nn.Sequential``). Under a fleet
    topology with ``num_stages`` pp stages only this rank's stage is
    built (see the module's docstring)."""

    def __init__(self, layers: Sequence, num_stages: int = 1,
                 loss_fn=None, seg_method: str = "uniform", topology=None,
                 recompute_interval: int = 0):
        super().__init__()
        self._descs = list(layers)
        self._num_stages = int(num_stages)
        self._loss_fn = loss_fn
        self._topology = topology
        self._recompute_interval = recompute_interval
        self._shared_instances: Dict[str, nn.Module] = {}
        self.segment_bounds = SegmentLayers(
            self._descs, self._num_stages, seg_method).do_segment()
        from ...fleet.topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        self._hcg = None
        if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
            if hcg.get_pipe_parallel_world_size() != self._num_stages:
                raise ValueError(
                    f"PipelineLayer of {self._num_stages} stages on a "
                    f"topology of pp degree "
                    f"{hcg.get_pipe_parallel_world_size()}")
            self._hcg = hcg
        self.stage_id = hcg.get_stage_id() if self._hcg else None
        self._stages: Dict[int, nn.Sequential] = {}
        for s in range(self._num_stages):
            if self.stage_id is not None and s != self.stage_id:
                continue
            lo, hi = self.segment_bounds[s], self.segment_bounds[s + 1]
            stage = nn.Sequential(*[self._build(d)
                                    for d in self._descs[lo:hi]])
            self._stages[s] = stage
            self.add_module(f"stage_{s}", stage)
        self._shared_groups = self._make_shared_groups()
        self.broadcast_shared_weights()

    def _build(self, desc):
        if isinstance(desc, SharedLayerDesc):
            key = desc.layer_name
            if key not in self._shared_instances:
                inst = desc.build_layer()
                self._shared_instances[key] = inst
                wrapper = _SharedCall(inst, desc.forward_func)
                # the stage's first site owns the params
                wrapper.add_module("shared", inst)
                return wrapper
            return _SharedCall(self._shared_instances[key],
                               desc.forward_func)
        if isinstance(desc, LayerDesc):
            built = desc.build_layer()
        elif isinstance(desc, nn.Module):
            built = desc
        elif callable(desc):
            built = _FnLayer(desc)
        else:
            raise TypeError(f"cannot build pipeline layer from {desc!r}")
        if self._recompute_interval:
            return _Recomputed(built)
        return built

    def _shared_stages(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                s = next(k for k in range(self._num_stages)
                         if self.segment_bounds[k] <= i
                         < self.segment_bounds[k + 1])
                stages = out.setdefault(d.layer_name, [])
                if s not in stages:
                    stages.append(s)
        return out

    def _make_shared_groups(self) -> Dict[str, tuple]:
        """key -> (the group of this rank's stages that hold it, the
        global rank of the lowest), for the keys more than one stage
        holds. Every rank creates every subset group, in one order."""
        if self._hcg is None:
            return {}
        from ...collective import new_group
        pp_group = self._hcg.get_pipe_parallel_group()
        lists = self._hcg.topology().get_comm_list("pp")
        out = {}
        for key, stages in sorted(self._shared_stages().items()):
            if len(stages) < 2:
                continue
            if len(stages) == self._num_stages:
                out[key] = (pp_group, pp_group.ranks[stages[0]])
                continue
            mine = None
            for ranks in lists:
                g = new_group([ranks[s] for s in stages], axis_name="pp")
                if self._hcg.get_global_rank() in g.ranks:
                    mine = g
            if self.stage_id in stages:
                out[key] = (mine, pp_group.ranks[stages[0]])
        return out

    @torch.no_grad()
    def broadcast_shared_weights(self) -> None:
        """Every shared layer's parameters from its lowest stage."""
        from ...collective import broadcast
        for key, (group, src) in self._shared_groups.items():
            for p in self._shared_instances[key].parameters():
                broadcast(p.data, src, group)

    @torch.no_grad()
    def allreduce_shared_weight_gradients(self) -> None:
        """Sum each shared layer's gradient over the stages that hold
        it (a stage whose uses did not reach it contributes zeros)."""
        from ...collective import all_reduce
        for key, (group, _) in self._shared_groups.items():
            for p in self._shared_instances[key].parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                all_reduce(p.grad, group=group)

    @property
    def num_stages(self) -> int:
        return self._num_stages

    def stage(self, i: int) -> nn.Sequential:
        if i not in self._stages:
            raise ValueError(f"stage {i} is built on another rank (this "
                             f"rank holds stage {self.stage_id})")
        return self._stages[i]

    def shared_layer(self, key: str) -> nn.Module:
        return self._shared_instances[key]

    def forward(self, x):
        if self._hcg is not None:
            raise RuntimeError(
                "this rank holds one stage of the pipeline; run it through "
                "PipelineParallel (train_batch / eval_batch)")
        for s in range(self._num_stages):
            x = self._stages[s](x)
        return x

    def loss(self, output, labels):
        if self._loss_fn is None:
            raise ValueError("PipelineLayer built without loss_fn")
        return self._loss_fn(output, labels)


class _Recomputed(Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *a, **kw):
        from ...fleet.utils import recompute
        return recompute(self.inner, *a, **kw)


class _FnLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)
