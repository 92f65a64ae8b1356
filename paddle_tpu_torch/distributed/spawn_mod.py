"""``paddle.distributed.spawn`` for the port.

Counterpart of ``paddle_tpu/distributed/spawn_mod.py``: start
``nprocs`` processes (the ``spawn`` start method: a fresh interpreter
each, never a fork of a process that holds a CUDA context) that run
``func(*args)`` with the launcher's environment set, the JAX protocol
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``,
``PADDLE_LOCAL_RANK``) and torch's (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
so ``init_parallel_env()`` in the worker joins the world. ``func`` is a
picklable callable or a ``"module:function"`` string, which the worker
imports itself (a worker then never imports the caller's module).
Without ``port`` the OS picks a free one.

``join`` waits for every worker; when one fails it stops the others
and raises a ``RuntimeError`` carrying the first failure's traceback.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import time
import traceback
from typing import Optional, Sequence

__all__ = ["spawn", "SpawnContext"]


def _resolve(func):
    if isinstance(func, str):
        mod, _, name = func.partition(":")
        return getattr(importlib.import_module(mod), name)
    return func


def _worker(func, args, rank: int, nprocs: int, master: str, port: int,
            errors) -> None:
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": master, "PADDLE_LOCAL_RANK": str(rank),
        "RANK": str(rank), "WORLD_SIZE": str(nprocs),
        "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(nprocs),
        "MASTER_ADDR": master, "MASTER_PORT": str(port),
    })
    try:
        _resolve(func)(*args)
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise SystemExit(1)


class SpawnContext:
    def __init__(self, procs, errors):
        self.processes = procs
        self._errors = errors

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for every worker (at most ``timeout`` seconds). The first
        worker to fail stops the rest; its traceback is raised."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            failed = [p for p in self.processes
                      if p.exitcode not in (0, None)]
            if failed:
                for p in self.processes:          # fail fast: stop peers
                    if p.is_alive():
                        p.terminate()
                for p in self.processes:
                    p.join(5)
                codes = {p.pid: p.exitcode for p in failed}
                detail = ""
                if not self._errors.empty():
                    rank, tb = self._errors.get()
                    detail = f"\nrank {rank} raised:\n{tb}"
                raise RuntimeError(f"spawned workers failed: {codes}"
                                   + detail)
            if all(p.exitcode == 0 for p in self.processes):
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.02)


def spawn(func, args: Sequence = (), nprocs: int = 1, join: bool = True,
          master: str = "127.0.0.1", port: Optional[int] = None,
          **options) -> SpawnContext:
    """Run ``func(*args)`` in ``nprocs`` fresh processes with the
    launcher's environment set; joins by default."""
    if port is None:
        from .parallel import _free_port
        port = _free_port()
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, tuple(args), rank, nprocs, master,
                              int(port), errors))
        p.daemon = options.get("daemon", False)
        p.start()
        procs.append(p)
    context = SpawnContext(procs, errors)
    if join:
        context.join()
    return context
