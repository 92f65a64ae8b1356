"""The distributed launcher: ``python -m paddle_tpu_torch.distributed.launch``.

Counterpart of ``paddle_tpu/distributed/launch/__init__.py``: start
``--nproc_per_node`` workers running ``script`` with the launcher's
environment (the JAX protocol, ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_MASTER`` / ``PADDLE_LOCAL_RANK``, and
torch's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``
/ ``MASTER_ADDR`` / ``MASTER_PORT``), each worker's output in
``log_dir/workerlog.<local rank>`` when a log directory is given, and
block until all exit. The first worker to fail stops the others
(SIGTERM) and its exit code is returned. A worker calls
``paddle_tpu_torch.distributed.init_parallel_env()`` to join the world:
NCCL with one card per local rank, or ``backend="gloo"`` when the
node's ranks outnumber its cards.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main"]


def _build_env(rank: int, world: int, master: str, port: int,
               local_rank: int, local_world: int, extra=None) -> dict:
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_MASTER": master, "PADDLE_LOCAL_RANK": str(local_rank),
        "RANK": str(rank), "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local_rank), "LOCAL_WORLD_SIZE": str(local_world),
        "MASTER_ADDR": master, "MASTER_PORT": str(port),
    })
    if extra:
        env.update(extra)
    return env


def launch(script: str, script_args: List[str], nproc_per_node: int = 1,
           nnodes: int = 1, node_rank: int = 0,
           master: Optional[str] = None, port: int = 12355,
           log_dir: Optional[str] = None) -> int:
    """Run ``nproc_per_node`` workers of ``script``; returns the first
    non-zero exit code (0 when all succeed). On a failure the remaining
    workers get SIGTERM."""
    master = master or "127.0.0.1"
    world = nproc_per_node * nnodes
    procs, logs = [], []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    for local_rank in range(nproc_per_node):
        rank = node_rank * nproc_per_node + local_rank
        env = _build_env(rank, world, master, port, local_rank,
                         nproc_per_node)
        out = None
        if log_dir:
            out = open(os.path.join(log_dir, f"workerlog.{local_rank}"), "w")
            logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", script, *script_args], env=env,
            stdout=out, stderr=out))
    rc = 0
    try:
        alive = set(range(len(procs)))
        while alive:
            for i in list(alive):
                code = procs[i].poll()
                if code is None:
                    continue
                alive.discard(i)
                if code != 0 and rc == 0:
                    rc = code
                    for j in alive:          # fail fast: stop the rest
                        procs[j].send_signal(signal.SIGTERM)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a distributed training job of the port")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--master", type=str, default=None,
                        help="coordinator host (default 127.0.0.1)")
    parser.add_argument("--port", type=int, default=12355)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("script", type=str)
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return launch(args.script, args.script_args,
                  nproc_per_node=args.nproc_per_node, nnodes=args.nnodes,
                  node_rank=args.node_rank, master=args.master,
                  port=args.port, log_dir=args.log_dir)
