"""fleet: the distributed-training facade.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:
:func:`init` starts the process group (``init_parallel_env``) and builds
the hybrid topology from ``strategy.hybrid_configs`` (with no
``dp_degree``, data parallelism over whatever the other degrees leave of
the world), :func:`distributed_model` wraps a model for the parallel
mode (``PipelineParallel``, ``TensorParallel``, ``ShardingParallel`` or
``DataParallel``; a model that carries a ``PipelineStageStack`` is laid
on the mesh as it is),
and :func:`distributed_optimizer` attaches a snapshot of the strategy
to the optimizer, which ``TrainStep`` reads (``gradient_merge``): a
bare optimizer is never rewired by ``fleet.init``.

and LocalSGD (``strategy.localsgd`` / ``adaptive_localsgd``) makes
``TrainStep`` a ``meta_optimizers.LocalSGDTrainStep``.
:func:`save_persistables` / :func:`load_persistables` commit and
restore a ``TrainStep``'s whole state or a layer's parameters and
buffers through ``distributed.checkpoint``, sharded when a mesh is
active (each rank writes the blocks it owns). The file datasets are
:mod:`.dataset` (``QueueDataset``, ``InMemoryDataset``), the storage
transports ``utils.fs`` and the restartable loop :mod:`.elastic`.
"""

from __future__ import annotations

from typing import Optional

from .. import env
from .dataset import InMemoryDataset, QueueDataset
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       MeshTopologyError, get_hybrid_communicate_group,
                       set_hybrid_communicate_group, validate_topology)

__all__ = ["init", "DistributedStrategy", "HybridCommunicateGroup",
           "MeshTopologyError", "CommunicateTopology",
           "get_hybrid_communicate_group", "validate_topology",
           "distributed_model", "distributed_optimizer", "reset",
           "worker_index", "worker_num", "is_first_worker",
           "barrier_worker", "init_is_called", "InMemoryDataset",
           "QueueDataset", "save_persistables", "load_persistables"]

_fleet_state = {"initialized": False, "strategy": None}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None,
         backend: Optional[str] = None):
    """Start the process group and build the hybrid topology (the JAX
    ``fleet.init``). ``backend`` goes to ``init_parallel_env`` (gloo
    when the node's ranks outnumber its cards)."""
    from ..parallel import init_parallel_env
    init_parallel_env(backend)
    if strategy is None:
        strategy = DistributedStrategy()
    cfg = strategy.hybrid_configs
    world = env.get_world_size()
    mp = int(cfg.get("mp_degree", 1))
    pp = int(cfg.get("pp_degree", 1))
    sh = int(cfg.get("sharding_degree", 1))
    sp = int(cfg.get("sp_degree", 1))
    dp = int(cfg.get("dp_degree", 0)) or max(1, world // (mp * pp * sh * sp))
    hcg = HybridCommunicateGroup(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                                 sharding_degree=sh, sp_degree=sp)
    set_hybrid_communicate_group(hcg)
    _fleet_state["initialized"] = True
    _fleet_state["strategy"] = strategy


def init_is_called() -> bool:
    return _fleet_state["initialized"]


def _strategy() -> DistributedStrategy:
    if _fleet_state["strategy"] is None:
        _fleet_state["strategy"] = DistributedStrategy()
    return _fleet_state["strategy"]


def worker_index() -> int:
    return env.get_rank()


def worker_num() -> int:
    return env.get_world_size()


def is_first_worker() -> bool:
    return env.get_rank() == 0


def barrier_worker() -> None:
    from ..collective import barrier
    barrier()


def distributed_model(model):
    """Wrap ``model`` for the active parallel mode: ``PipelineParallel``
    (pp, over a ``PipelineLayer``; a model carrying a
    ``PipelineStageStack`` is laid on the mesh and returned),
    ``TensorParallel`` (mp), ``ShardingParallel`` (sharding) or
    ``DataParallel``."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        init()
        hcg = get_hybrid_communicate_group()
    mode = hcg.get_parallel_mode()
    from .. import meta_parallel
    if mode == "pipeline":
        if not isinstance(model, meta_parallel.PipelineLayer) and any(
                isinstance(m, meta_parallel.PipelineStageStack)
                for m in model.modules()):
            from ..spmd import apply_param_shardings
            return apply_param_shardings(model, hcg.mesh)
        return meta_parallel.PipelineParallel(model, hcg, _strategy())
    if mode == "model":
        return meta_parallel.TensorParallel(model, hcg, _strategy())
    if mode == "sharding":
        return meta_parallel.ShardingParallel(model, hcg, _strategy())
    from ..parallel import DataParallel
    return DataParallel(model, group=hcg.get_data_parallel_group())


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """Attach a snapshot of the strategy (and the hybrid topology) to
    ``optimizer``: ``TrainStep`` reads its gradient merge from there
    only. Later changes to the strategy object do not reach it."""
    snap = strategy if strategy is not None else _strategy()
    frozen = DistributedStrategy()
    frozen.__dict__["_config"] = snap.to_dict()
    optimizer._fleet_strategy = frozen
    optimizer._hybrid_context = get_hybrid_communicate_group()
    return optimizer


def _layer_state(layer):
    """A layer's ``{"params", "buffers"}``: on a mesh each parameter a
    ``checkpoint.Shard`` of its block (its ``_dist_layout`` over the
    mesh; a replicated one whole, written by the rank at coordinate 0 of
    every axis), so every rank writes only what it owns."""
    from ..checkpoint import Shard
    from ..spmd import mesh_slice
    mesh = env.get_mesh()

    def leaf(p):
        t = p.detach()
        if mesh is None or mesh.coords is None or not t.dim():
            return t
        layout = getattr(p, "_dist_layout", {})
        full = tuple(getattr(p, "_full_shape", t.shape))
        spec, starts, used = [None] * len(full), [0] * len(full), set()
        for d, axes in layout.items():
            spec[d] = list(axes)
            starts[d] = mesh_slice(mesh, axes, full[d])[0]
            used.update(axes)
        owner = all(mesh.axis_rank(a) == 0 for a in mesh.axis_names
                    if a not in used)
        return Shard(t, full, starts, spec, owner)
    return {"params": {k: leaf(p) for k, p in layer.named_parameters()},
            "buffers": {k: b.detach() for k, b in layer.named_buffers()}}


def save_persistables(obj, dirname: str, asynchronous: bool = True):
    """Commit the training state at ``dirname`` (the reference's
    ``fleet_base.save_persistables``; a sharded save here, each rank
    writing its own blocks, where the reference funnels every persistable
    through trainer 0). ``obj`` is a ``jit.TrainStep`` (the whole state,
    optimizer slots included: ``checkpoint.save_train_step``) or a layer
    (its parameters and buffers). On a mesh every rank calls it.
    Asynchronous by default (``checkpoint.wait`` commits)."""
    from .. import checkpoint as dckpt
    from ...jit import TrainStep
    if isinstance(obj, TrainStep):
        dckpt.save_train_step(obj, dirname, asynchronous=asynchronous)
        return
    dckpt.save(_layer_state(obj), dirname, asynchronous=asynchronous)


def load_persistables(obj, dirname: str):
    """Restore what :func:`save_persistables` committed into ``obj``, in
    ``obj``'s own layout, whatever layout saved it: a ``TrainStep``
    through ``checkpoint.load_train_step``, a layer by copying each
    parameter's block of the whole array (``spmd.cut_block`` of its
    ``_dist_layout`` on the active mesh) and each buffer in place. The
    names and whole shapes must match. Returns ``obj``."""
    import torch

    from .. import checkpoint as dckpt
    from ..spmd import cut_block
    from ...jit import TrainStep
    if isinstance(obj, TrainStep):
        dckpt.load_train_step(obj, dirname)
        return obj
    state = dckpt.load(dirname)
    saved = dict(state.get("params", {}), **state.get("buffers", {}))
    mine = dict(obj.named_parameters())
    mine.update(obj.named_buffers())
    if sorted(saved) != sorted(mine):
        raise ValueError(
            f"{dirname} holds {sorted(set(saved) - set(mine))} that the "
            f"layer lacks and lacks {sorted(set(mine) - set(saved))}")
    mesh = env.get_mesh()
    with torch.no_grad():
        for k, t in mine.items():
            full = torch.as_tensor(saved[k])
            layout = getattr(t, "_dist_layout", None)
            if layout and mesh is not None:
                full = cut_block(full, layout, mesh)
            if tuple(full.shape) != tuple(t.shape):
                raise ValueError(f"{k}: saved {tuple(full.shape)}, the "
                                 f"layer holds {tuple(t.shape)}")
            t.copy_(full)
    return obj


def reset() -> None:
    """Forget the fleet state and the active mesh (the process group
    stays: ``collective.destroy_process_group``)."""
    _fleet_state["initialized"] = False
    _fleet_state["strategy"] = None
    set_hybrid_communicate_group(None)
    env.reset()
