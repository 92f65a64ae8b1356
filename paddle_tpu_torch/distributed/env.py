"""Distributed environment state.

Counterpart of ``paddle_tpu/distributed/env.py``. The JAX package keeps
the active ``jax.sharding.Mesh`` and whether ``jax.distributed`` was
initialized; the port keeps the active :class:`~.spmd.Mesh` (the
process groups of its axes) and reads the rank and world size from
``torch.distributed`` once a process group exists, else from the
launcher's environment: the JAX protocol (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``) or torch's (``RANK``, ``WORLD_SIZE``).

The JAX module's bound-axis tracking and ``shard_map`` shim have no
counterpart: each rank is its own process and every collective is an
eager call on its own tensor. ``set_data_axis`` / ``current_data_axis``
(``env.py:81-87``) name the mesh axis whose group ``nn.SyncBatchNorm``
averages its statistics over while one is set.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["get_rank", "get_world_size", "get_local_rank",
           "get_local_world_size", "set_mesh", "get_mesh",
           "mark_initialized", "is_initialized", "reset", "set_data_axis",
           "current_data_axis"]

_global = {"mesh": None, "initialized": False, "data_axis": None}


def _env_int(*names: str, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _pg_ready() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    if _pg_ready():
        import torch.distributed as dist
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size() -> int:
    if _pg_ready():
        import torch.distributed as dist
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def get_local_rank() -> int:
    return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=get_rank())


def get_local_world_size() -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE`` as the launchers set it,
    else the world (one node)."""
    return _env_int("LOCAL_WORLD_SIZE", default=get_world_size())


def set_mesh(mesh) -> None:
    _global["mesh"] = mesh


def get_mesh() -> Optional[object]:
    return _global["mesh"]


def mark_initialized() -> None:
    _global["initialized"] = True


def is_initialized() -> bool:
    return _global["initialized"]


def reset() -> None:
    """Forget the active mesh and the initialized mark (tests, re-init);
    the process group, if any, stays (``destroy_process_group``)."""
    _global["mesh"] = None
    _global["initialized"] = False
    _global["data_axis"] = None


def set_data_axis(name: Optional[str]) -> None:
    """Name the mesh axis ``SyncBatchNorm`` averages its statistics over
    (None: none)."""
    _global["data_axis"] = name


def current_data_axis() -> Optional[str]:
    return _global["data_axis"]
