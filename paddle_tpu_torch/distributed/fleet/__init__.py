"""fleet: the distributed-training facade.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:
:func:`init` starts the process group (``init_parallel_env``) and builds
the hybrid topology from ``strategy.hybrid_configs`` (with no
``dp_degree``, data parallelism over whatever the other degrees leave of
the world), :func:`distributed_model` wraps a model for the parallel
mode (``TensorParallel``, ``ShardingParallel`` or ``DataParallel``),
and :func:`distributed_optimizer` attaches a snapshot of the strategy
to the optimizer, which ``TrainStep`` reads (``gradient_merge``): a
bare optimizer is never rewired by ``fleet.init``.

The fleet dataset, the ``fs`` helpers, ``save_persistables`` /
``load_persistables`` (sharded checkpoints) and LocalSGD come with the
later parts of ``distributed/``.
"""

from __future__ import annotations

from typing import Optional

from .. import env
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       MeshTopologyError, get_hybrid_communicate_group,
                       set_hybrid_communicate_group, validate_topology)

__all__ = ["init", "DistributedStrategy", "HybridCommunicateGroup",
           "MeshTopologyError", "CommunicateTopology",
           "get_hybrid_communicate_group", "validate_topology",
           "distributed_model", "distributed_optimizer", "reset",
           "worker_index", "worker_num", "is_first_worker",
           "barrier_worker", "init_is_called"]

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
    """Wrap ``model`` for the active parallel mode: ``TensorParallel``
    (mp), ``ShardingParallel`` (sharding) or ``DataParallel``."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        init()
        hcg = get_hybrid_communicate_group()
    mode = hcg.get_parallel_mode()
    from .. import meta_parallel
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


def reset() -> None:
    """Forget the fleet state and the active mesh (the process group
    stays: ``collective.destroy_process_group``)."""
    _fleet_state["initialized"] = False
    _fleet_state["strategy"] = None
    set_hybrid_communicate_group(None)
    env.reset()
