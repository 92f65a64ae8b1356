"""Elastic training: failure detection and a restartable training loop.

Counterpart of ``paddle_tpu/distributed/fleet/elastic/__init__.py`` (the
reference's ``fleet/elastic/manager.py``: an ElasticManager that watches
etcd for host membership and decides HOLD / RESTART / COMPLETED / ERROR
between min and max parallelism, over the ``PADDLE_ELASTIC_*``
environment). As in the JAX package, etcd is replaced by a file-based
heartbeat registry (one small file per worker under a shared
directory), and the kill-and-relaunch model by the supervisor
:func:`run_elastic`, which pairs with the port's ``jit.TrainStep.save``
/ ``load`` (the whole training state, dropout generator and step count
included): a restart resumes from the last good step, bit for bit. A
failure inside training surfaces as an exception in the rank's process.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Optional

__all__ = ["ElasticStatus", "ElasticManager", "run_elastic"]


class ElasticStatus:
    COMPLETED = "completed"
    RESTART = "restart"
    HOLD = "hold"
    ERROR = "error"
    EXIT = "exit"


class ElasticManager:
    """Worker membership via heartbeat files (the reference's etcd hosts
    path).

    Each worker touches ``<root>/worker_<rank>.hb`` with its pid and
    timestamp; `watch()` classifies the cluster state: all expected workers
    alive -> HOLD, a worker stale/dead but replaceable within
    [min_np, max_np] -> RESTART, job marker complete -> COMPLETED.
    """

    def __init__(self, root: Optional[str] = None,
                 rank: Optional[int] = None, np_: Optional[int] = None,
                 min_np: Optional[int] = None, max_np: Optional[int] = None,
                 timeout: float = 30.0, job_id: Optional[str] = None):
        env = os.environ
        base = root or env.get("PADDLE_ELASTIC_DIR", os.path.join(
            tempfile.gettempdir(), "paddle_tpu_torch_elastic"))
        # per-job namespace: a finished job's COMPLETED marker must not
        # classify the next job (reference: etcd prefix = job_id)
        job = job_id or env.get("PADDLE_ELASTIC_JOB_ID")
        self.root = os.path.join(base, job) if job else base
        self.rank = int(rank if rank is not None
                        else env.get("PADDLE_TRAINER_ID", 0))
        self.np = int(np_ if np_ is not None
                      else env.get("PADDLE_TRAINERS_NUM", 1))
        elastic = env.get("PADDLE_ELASTIC_NP", "")
        if ":" in elastic:
            lo, hi = elastic.split(":")
            self.min_np, self.max_np = int(lo), int(hi)
        else:
            self.min_np = int(min_np if min_np is not None else self.np)
            self.max_np = int(max_np if max_np is not None else self.np)
        self.timeout = timeout
        os.makedirs(self.root, exist_ok=True)
        self.enabled = self.max_np > 1 or "PADDLE_ELASTIC_NP" in env

    # -- heartbeat ---------------------------------------------------------
    def _hb_path(self, rank):
        return os.path.join(self.root, f"worker_{rank}.hb")

    def _write_marker(self, path: str, payload: str):
        """One registry-store write. The registry directory is a shared
        filesystem (NFS): transient EIO/ESTALE under load is normal, so
        every store write goes through exponential backoff with jitter
        (the helper the HDFS transport uses); a worker must not be
        declared dead because one heartbeat write hit a slow server.
        Write-then-rename keeps readers from seeing a torn heartbeat as
        a dead worker."""
        from ..utils.fs import retry_with_backoff

        def attempt():
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, path)

        retry_with_backoff(attempt, retries=3, base_delay=0.05,
                           max_delay=2.0, retry_on=(OSError,),
                           what=f"elastic store write {path}")

    def beat(self):
        self._write_marker(self._hb_path(self.rank), json.dumps(
            {"pid": os.getpid(), "ts": time.time()}))

    def alive_workers(self):
        now = time.time()
        alive = []
        for name in os.listdir(self.root):
            if not name.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    hb = json.load(f)
                if now - hb["ts"] <= self.timeout:
                    alive.append(int(name[len("worker_"):-3]))
            except (ValueError, OSError):
                continue
        return sorted(alive)

    def mark_completed(self):
        self._write_marker(os.path.join(self.root, "COMPLETED"),
                           str(time.time()))

    # -- state machine (the reference's manager.py ``watch``) -------------
    def watch(self) -> str:
        if os.path.exists(os.path.join(self.root, "COMPLETED")):
            return ElasticStatus.COMPLETED
        alive = self.alive_workers()
        if len(alive) >= self.np:
            return ElasticStatus.HOLD
        if len(alive) >= self.min_np:
            return ElasticStatus.RESTART     # degraded but viable: rescale
        return ElasticStatus.ERROR


def run_elastic(train_fn: Callable[[Optional[str]], None],
                checkpoint_path: str, max_restarts: int = 3,
                manager: Optional[ElasticManager] = None,
                sleep: Callable[[float], None] = time.sleep):
    """Supervised restartable training (the reference's relaunch loop,
    manager.py ``LauncherInterface``, folded into the rank's process).

    ``train_fn(resume_path_or_None)`` runs the training loop, calling
    ``TrainStep.save(checkpoint_path)`` at intervals; on an exception the
    supervisor waits ``min(2**restarts, 30)`` seconds (through
    ``sleep``) and calls it again with the checkpoint's path, up to
    ``max_restarts`` times. A background thread beats the heartbeat every
    ``timeout/3`` so peers' ``watch()`` sees this worker alive for the
    whole run. Returns ``train_fn``'s result.
    """
    import threading

    mgr = manager or ElasticManager()
    # stale COMPLETED from a previous job under the same root must not
    # instantly "finish" this one
    marker = os.path.join(mgr.root, "COMPLETED")
    if os.path.exists(marker):
        try:
            os.remove(marker)
        except OSError:
            pass

    stop = threading.Event()

    def heartbeat_loop():
        while not stop.is_set():
            try:
                mgr.beat()
            except OSError:
                pass
            stop.wait(max(mgr.timeout / 3.0, 0.1))

    hb = threading.Thread(target=heartbeat_loop, daemon=True)
    hb.start()
    restarts = 0
    try:
        while True:
            resume = (checkpoint_path if os.path.exists(checkpoint_path)
                      else None)
            try:
                result = train_fn(resume)
                mgr.mark_completed()
                return result
            except KeyboardInterrupt:
                raise
            except Exception:
                restarts += 1
                if restarts > max_restarts:
                    raise
                sleep(min(2.0 ** restarts, 30.0))
    finally:
        stop.set()
