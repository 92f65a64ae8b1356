"""``init_parallel_env`` and ``DataParallel``.

Counterpart of ``paddle_tpu/distributed/parallel.py``. The JAX package
starts ``jax.distributed`` from the launcher's environment; the port
starts a ``torch.distributed`` process group from the same environment
(the JAX protocol, ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_MASTER`` / ``MASTER_PORT``, or torch's ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``).

The backend rule: NCCL when a card is present, gloo on the CPU. NCCL
takes one card per rank (two ranks of one communicator on one device
fail with "Duplicate GPU detected"), so when more ranks share a node
than it has cards, ``init_parallel_env`` raises and names the rule,
unless the caller asks for ``backend="gloo"`` explicitly: then every
rank runs its collectives over gloo (host memory), CUDA tensors
included. There is no silent switch of backend.

``DataParallel.apply_collective_grads`` averages every gradient over
the group in place; inside ``no_sync()`` it does nothing, so gradients
accumulate locally until the first call outside it.
"""

from __future__ import annotations

import contextlib
import os
import socket
from typing import Optional

import torch
from torch import nn

from . import env

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "DataParallel", "ParallelEnv"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve_backend(backend: Optional[str]) -> str:
    cuda = torch.cuda.is_available()
    explicit = backend is not None
    backend = (backend or ("nccl" if cuda else "gloo")).lower()
    if backend == "nccl":
        if not cuda:
            raise RuntimeError("backend 'nccl' needs a CUDA device; the CPU "
                               "runs gloo")
        local, cards = env.get_local_world_size(), torch.cuda.device_count()
        if local > cards:
            how = "asked for" if explicit else "defaulted to"
            raise RuntimeError(
                f"{local} ranks share this node but it has {cards} CUDA "
                f"device(s), and NCCL takes one device per rank (two ranks "
                f"of one communicator on one device fail with 'Duplicate "
                f"GPU detected'); the run {how} nccl. Pass "
                "backend='gloo' to run every rank's collectives over host "
                "memory, or start one rank per device.")
    return backend


def init_parallel_env(backend: Optional[str] = None,
                      init_method: Optional[str] = None):
    """Start this rank's process group from the launcher's environment
    and return a :class:`ParallelEnv`. ``backend`` None picks NCCL on a
    card and gloo on the CPU (see the module's rule); ``init_method``
    (a ``tcp://`` or ``file://`` URL) overrides the master address. A
    world of one rank gets a process group too, on a free local port,
    so its collectives are real calls. On a card each rank's current
    device is its local rank modulo the cards. Idempotent."""
    import torch.distributed as dist
    if dist.is_initialized():
        env.mark_initialized()
        return ParallelEnv()
    rank = env.get_rank()
    world = env.get_world_size()
    backend = _resolve_backend(backend)
    if init_method is None:
        master = (os.environ.get("PADDLE_MASTER")
                  or os.environ.get("MASTER_ADDR") or "127.0.0.1")
        port = os.environ.get("MASTER_PORT") or (
            str(_free_port()) if world == 1 else "12355")
        init_method = f"tcp://{master}:{port}"
    if torch.cuda.is_available():
        torch.cuda.set_device(env.get_local_rank()
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    env.mark_initialized()
    return ParallelEnv()


def get_rank() -> int:
    return env.get_rank()


def get_world_size() -> int:
    return env.get_world_size()


class ParallelEnv:
    """The rank's view of the world (``fluid/dygraph/parallel.py``'s
    ParallelEnv)."""

    @property
    def rank(self) -> int:
        return env.get_rank()

    @property
    def world_size(self) -> int:
        return env.get_world_size()

    @property
    def local_rank(self) -> int:
        return env.get_local_rank()

    @property
    def device_id(self) -> int:
        if torch.cuda.is_available():
            return env.get_local_rank() % torch.cuda.device_count()
        return 0

    @property
    def backend(self) -> Optional[str]:
        import torch.distributed as dist
        return str(dist.get_backend()) if dist.is_initialized() else None

    nranks = world_size


class DataParallel(nn.Module):
    """Data-parallel wrapper: the forward is the layer's;
    :meth:`apply_collective_grads` averages every gradient over
    ``group`` (default: the world) after ``backward()``."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        self._sync = True

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self) -> None:
        """Average each gradient over the group in place (skipped inside
        :meth:`no_sync`)."""
        from .collective import ReduceOp, _default_group, all_reduce
        g = self._group or _default_group()
        if not self._sync or g.nranks <= 1:
            return
        for p in self._layers.parameters():
            if p.grad is not None:
                all_reduce(p.grad, ReduceOp.AVG, g)

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients accumulate locally inside the block: the first
        :meth:`apply_collective_grads` after it averages the sum."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)
