"""Parameter-server runtime: host-resident sparse tables.

Counterpart of ``paddle_tpu/distributed/ps/__init__.py``. Its job, as
there: embedding tables far larger than device memory, updated sparsely
(the reference's PS stack: SparseTable shards, pull / push, the fleet PS
roles).

- :class:`SparseTable` stays numpy in host memory, a copy of the JAX
  class, so its rows are bit-equal to the JAX table's from the same
  seed; ``ssd_table.py``, ``service.py`` (the C++ server, its client and
  the communicators) and ``graph.py`` are copies too.
- :class:`DistributedEmbedding` is an ``nn.Module`` whose forward pulls
  the host rows onto its device and whose backward pushes the rows'
  gradient into the table (fused server update, the reference's async
  push). The table is not a parameter: dense optimizers skip it.

The push is an autograd node (:class:`TableRows`). A
``torch.autograd.Function`` whose inputs need no gradient never enters
the graph, so each module holds an *anchor*, a zero-size tensor that
requires grad and is no parameter, and passes it as the node's input:
``loss.backward()`` then reaches the node, which pushes and returns no
gradient. Under ``torch.no_grad()`` no node is recorded and nothing is
pushed, as under the JAX ``is_grad_enabled()``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device

__all__ = ["SparseTable", "SSDSparseTable", "DistributedEmbedding",
           "GraphTable", "GraphService", "GraphClient",
           "PSClient", "PSServerHandle", "AsyncCommunicator",
           "GeoCommunicator", "run_server", "role_from_env",
           "server_endpoints_from_env"]

from .graph import GraphClient, GraphService, GraphTable  # noqa: E402
from .service import (AsyncCommunicator, GeoCommunicator,  # noqa: E402
                      PSClient, PSServerHandle, role_from_env, run_server,
                      server_endpoints_from_env)
from .ssd_table import SSDSparseTable  # noqa: E402
from ...nn.layer import Layer


class SparseTable:
    """Host-memory embedding shard with sparse optimizers.

    reference: fluid/distributed SparseTable + DownpourWorker push/pull;
    optimizers follow the PS convention (sgd | adagrad, applied row-wise
    on push).
    """

    def __init__(self, num_rows: int, dim: int, initializer=None,
                 optimizer: str = "adagrad", lr: float = 0.05,
                 shard_id: int = 0, num_shards: int = 1, seed: int = 0):
        self.num_rows = num_rows
        self.dim = dim
        self.shard_id = shard_id
        self.num_shards = num_shards
        # each shard stores ONLY its rows (ids with id % num_shards ==
        # shard_id): that is the whole point of sharding a
        # bigger-than-one-host table
        self.local_rows = (num_rows + num_shards - 1 - shard_id) \
            // num_shards
        rng = np.random.default_rng(seed + shard_id)
        scale = 1.0 / np.sqrt(dim)
        self.data = (initializer(self.local_rows, dim)
                     if initializer is not None
                     else rng.uniform(-scale, scale,
                                      (self.local_rows, dim))
                     .astype(np.float32))
        self.optimizer = optimizer
        self.lr = lr
        if optimizer == "adagrad":
            self._g2 = np.zeros((self.local_rows,), np.float32)
        elif optimizer != "sgd":
            raise ValueError(f"unknown PS optimizer {optimizer!r}")
        self.pull_count = 0
        self.push_count = 0

    def _local(self, ids: np.ndarray) -> np.ndarray:
        if self.num_shards > 1:
            if not ((ids % self.num_shards) == self.shard_id).all():
                raise ValueError("ids routed to the wrong shard")
            return ids // self.num_shards
        return ids

    def pull(self, ids) -> np.ndarray:
        """Gather rows for ids (reference: pull_sparse)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        self.pull_count += 1
        return self.data[self._local(ids)]

    def push(self, ids, grads) -> None:
        """Apply a sparse update for ids (reference: push_sparse).
        Duplicate ids accumulate before the update, matching dense
        embedding-gradient semantics."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        local = self._local(ids)
        uniq, inv = np.unique(local, return_inverse=True)
        acc = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(acc, inv, grads)
        if self.optimizer == "adagrad":
            self._g2[uniq] += (acc ** 2).mean(axis=1)
            denom = np.sqrt(self._g2[uniq])[:, None] + 1e-10
            self.data[uniq] -= self.lr * acc / denom
        else:
            self.data[uniq] -= self.lr * acc
        self.push_count += 1

    # -- raw row access (tier promotion/demotion; no optimizer step) -------
    def read_rows(self, ids):
        """(vecs [n, dim], g2 [n]) WITHOUT counting a pull — the tier
        manager's raw read when promoting rows into a faster tier."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        local = self._local(ids)
        g2 = (self._g2[local].copy() if self.optimizer == "adagrad"
              else np.zeros(len(local), np.float32))
        return self.data[local].copy(), g2

    def write_rows(self, ids, vecs, g2=None) -> None:
        """Overwrite rows (and optimizer state) verbatim — the tier
        manager's demotion write-back. NOT a push: no gradient math."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        local = self._local(ids)
        self.data[local] = np.asarray(vecs, np.float32).reshape(
            len(local), self.dim)
        if self.optimizer == "adagrad" and g2 is not None:
            self._g2[local] = np.asarray(g2, np.float32).reshape(-1)

    # -- checkpoint --------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {"data": self.data}
        if self.optimizer == "adagrad":
            out["g2"] = self._g2
        return out

    def load_state_dict(self, state):
        self.data = np.asarray(state["data"], np.float32)
        if self.optimizer == "adagrad" and "g2" in state:
            self._g2 = np.asarray(state["g2"], np.float32)


# ---------------------------------------------------------------------------
# the push as an autograd node
# ---------------------------------------------------------------------------

def make_anchor() -> torch.Tensor:
    """The zero-size tensor a module passes to :class:`TableRows` so
    that the node enters the graph (kept as a plain attribute: no
    parameter, no buffer, no state-dict key)."""
    return torch.zeros(0, requires_grad=True)


class TableRows(torch.autograd.Function):
    """``TableRows.apply(anchor, pulls, pushes)``: calls each
    ``pulls[i]()`` (a tensor of rows) in order and returns them; the
    backward calls ``pushes[i](grad_i)`` in REVERSE order, the order in
    which the JAX tape runs the nodes of one forward, so that pushes into
    a table shared by several outputs apply in the JAX order (each
    adagrad push changes the row state the next one reads). An output
    that got no gradient is not pushed. Returns no gradient: the rows
    live in their tables, not in the graph."""

    @staticmethod
    def forward(ctx, anchor, pulls: Sequence[Callable[[], torch.Tensor]],
                pushes: Sequence[Callable[[torch.Tensor], None]]):
        ctx.pushes = list(pushes)
        ctx.set_materialize_grads(False)
        return tuple(pull() for pull in pulls)

    @staticmethod
    def backward(ctx, *grads):
        for push, g in reversed(list(zip(ctx.pushes, grads))):
            if g is not None:
                push(g)
        return None, None, None


def host_grad(g: torch.Tensor) -> np.ndarray:
    """A pushed gradient as host float32 numpy (one device-to-host copy
    on the card)."""
    return g.detach().float().cpu().numpy()


class DistributedEmbedding(Layer):
    """Embedding whose table lives in host memory (PS-style).

    forward: host pull -> rows on ``device`` (the card unless
    ``device="cpu"``); backward: the autograd node pushes the row
    gradients straight into the table (fused server update — the
    reference's async push). The table is NOT a parameter: dense
    optimizers skip it, exactly like the reference's PS-mode embeddings.

    Two backends:
      - in-process :class:`SparseTable` (default): host RAM of this
        worker;
      - a remote PS service via ``client=PSClient(...)`` + ``table_id=``:
        rows pulled over TCP from the C++ server processes; gradients
        pushed either synchronously or through an ``AsyncCommunicator``
        (the reference's async-SGD mode).
    """

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 table: Optional[SparseTable] = None, lr: float = 0.05,
                 optimizer: str = "adagrad", name=None, client=None,
                 table_id: int = 0, communicator=None,
                 device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.client = client
        self.table_id = table_id
        self.communicator = communicator
        if client is None:
            self.table = table or SparseTable(num_embeddings, embedding_dim,
                                              optimizer=optimizer, lr=lr)
        else:
            self.table = None
        self.embedding_dim = embedding_dim
        self._anchor = make_anchor()

    def _pull(self, ids_np: np.ndarray) -> np.ndarray:
        flat = ids_np.reshape(-1)
        if self.client is not None:
            return self.client.pull_sparse(self.table_id,
                                           flat.astype(np.uint64),
                                           self.embedding_dim)
        return self.table.pull(flat)

    def _push(self, ids_np: np.ndarray, grads: np.ndarray) -> None:
        flat = ids_np.reshape(-1).astype(np.uint64)
        g = grads.reshape(len(flat), self.embedding_dim)
        if self.client is None:
            self.table.push(ids_np.reshape(-1), g)
        elif self.communicator is not None:
            self.communicator.push_sparse_grad(self.table_id, flat, g)
        else:
            self.client.push_sparse(self.table_id, flat, g, grad=True)

    def forward(self, ids) -> torch.Tensor:
        ids_np = np.asarray(ids.detach().cpu() if isinstance(
            ids, torch.Tensor) else ids)
        shape = ids_np.shape + (self.embedding_dim,)

        def pull():
            rows = np.ascontiguousarray(self._pull(ids_np), np.float32)
            return torch.from_numpy(rows.reshape(shape)).to(self.device)

        def push(g):
            self._push(ids_np, host_grad(g))

        (out,) = TableRows.apply(self._anchor, [pull], [push])
        return out
