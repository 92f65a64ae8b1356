"""Device-resident embedding table, row-sharded over a ``ps`` mesh axis,
with dedup lookups and colocated sparse-optimizer state.

Counterpart of ``paddle_tpu/recsys/sharded_table.py``. Ownership is the
SparseTable convention: row ``u`` lives on shard ``u % n`` at local row
``u // n``, and shard ``s`` draws its rows from ``default_rng(seed + s)``
(so a one-shard table is ``SparseTable(seed)`` bit for bit). The adagrad
row accumulators live beside the rows they update.

Two dispatch modes, resolved per call:

- **local**: no mesh, or no ``ps`` axis above 1. The table holds the
  whole ``[1, R, D]`` array (and ``g2 [1, R]``) on its device; the JAX
  package's local mode.
- **manual**: on a mesh whose ``ps`` axis has ``n > 1`` ranks, a ps rank
  is a process (as dp, mp, pp and ep ranks are in the port) and holds
  only its block ``[1, R, D]`` of the JAX ``[n, R, D]``. A lookup is the
  JAX ``shard_map`` body: each rank gathers the unique ids it owns, zeros
  the others, and one ``all_reduce(SUM)`` over the ps group assembles
  the batch. Each row has exactly one nonzero contributor, so the result
  equals a gather bit for bit. An update runs on the owning shard only.
  Every ps rank calls ``lookup`` / ``apply_grads`` with the same ids (and
  gradients): the ps axis replicates the batch, as in the JAX program.

The JAX auto path (``FLAGS_recsys_sharded_lookup`` off on a ps mesh) is
GSPMD and has no counterpart when ranks are processes: the port raises
``NotImplementedError`` there (:func:`~paddle_tpu_torch.recsys.
note_recsys_fallback`).

Dedup (``FLAGS_recsys_dedup``, default on): sort-unique the batch ids,
fetch each distinct row once, inverse-permute back. Gradients accumulate
over the unique set before the row update regardless of the flag (on the
host, ``np.add.at``, as in JAX); the flag only governs gather traffic, so
off is the bit-compatible per-id oracle.

``state_dict`` / ``load_state_dict`` keep the JAX global form (``data
[num_rows, D]``, ``g2 [num_rows]`` in row order), so a checkpoint moves
between the packages and across ps layouts; on a ps mesh ``state_dict``
gathers the shards (every ps rank calls it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.flags import get_flag
from . import RECSYS_STATS, note_recsys_fallback

__all__ = ["PS_AXIS", "ShardedEmbeddingTable"]

PS_AXIS = "ps"


class ShardedEmbeddingTable:
    """Device-resident embedding shards over the mesh ``ps`` axis.

    Protocol-compatible with :class:`~paddle_tpu_torch.distributed.ps.
    SparseTable` (``pull``/``push``/``state_dict``), so
    ``DistributedEmbedding(table=...)`` and the tier manager work
    unchanged; :meth:`lookup` / :meth:`apply_grads` are the device-tensor
    fast path the DLRM model and the serving engine use."""

    def __init__(self, num_rows: int, dim: int, optimizer: str = "adagrad",
                 lr: float = 0.05, seed: int = 0, axis: str = PS_AXIS,
                 initializer=None, device: DeviceLike = None):
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unknown PS optimizer {optimizer!r}")
        from ..distributed import env as dist_env
        self.device = resolve_device(device)
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.optimizer = optimizer
        self.lr = float(lr)
        self.seed = int(seed)
        self.axis = axis
        mesh = dist_env.get_mesh()
        self._group = None
        self.num_shards, self.shard = 1, 0
        if mesh is not None and axis in mesh.axis_names \
                and mesh.axis_size(axis) > 1:
            self._group = mesh.group(axis)
            self.num_shards = int(mesh.axis_size(axis))
            self.shard = int(mesh.axis_rank(axis))
        self._rows_per_shard = (self.num_rows + self.num_shards - 1) \
            // self.num_shards
        self.data = torch.from_numpy(
            self._init_block(self.shard, initializer)[None]).to(self.device)
        self.g2 = torch.zeros((1, self._rows_per_shard), dtype=torch.float32,
                              device=self.device)
        self.pull_count = 0
        self.push_count = 0
        self.ids_seen = 0
        self.rows_fetched = 0
        self.bytes_pulled = 0
        self.bytes_pushed = 0

    def _init_block(self, s: int, initializer) -> np.ndarray:
        """Shard ``s``'s ``[R, D]`` rows, zero-padded to ``R``: the JAX
        table's block ``s``."""
        n = self.num_shards
        local = (self.num_rows + n - 1 - s) // n
        if initializer is not None:
            block = np.asarray(initializer(local, self.dim), np.float32)
        else:
            # per-shard rng stream == SparseTable(shard_id=s): a
            # 1-shard table matches SparseTable(seed) bit-for-bit
            rng = np.random.default_rng(self.seed + s)
            scale = 1.0 / np.sqrt(self.dim)
            block = rng.uniform(-scale, scale,
                                (local, self.dim)).astype(np.float32)
        if local < self._rows_per_shard:
            block = np.concatenate(
                [block, np.zeros((self._rows_per_shard - local, self.dim),
                                 np.float32)])
        return block

    # -- dispatch-mode resolution ------------------------------------------
    def _mode(self) -> str:
        if self._group is None:
            return "local"
        if not bool(get_flag("recsys_sharded_lookup")):
            note_recsys_fallback("flag_off")
        return "manual"

    def _check_ids(self, ids) -> np.ndarray:
        """Range-validate both surfaces: an out-of-range id would update
        a wrong or padding row; reject it loudly instead, like
        SparseTable's wrong-shard check."""
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        if ids_np.size and (ids_np.min() < 0
                            or ids_np.max() >= self.num_rows):
            raise ValueError(
                f"embedding ids outside [0, {self.num_rows})")
        return ids_np

    def _dedup(self, ids: np.ndarray):
        """(uniq, inv) under the dedup flag; flag off = identity (the
        per-id gather oracle). Accounting feeds the bench's dedup
        ratio: ids_seen / rows_fetched."""
        self.ids_seen += ids.size
        if bool(get_flag("recsys_dedup")):
            uniq, inv = np.unique(ids, return_inverse=True)
        else:
            uniq, inv = ids, np.arange(ids.size)
        self.rows_fetched += uniq.size
        return uniq.astype(np.int64), inv.reshape(-1)

    @property
    def dedup_ratio(self) -> float:
        """Mean ids-per-fetched-row since construction (1.0 = no reuse)."""
        return self.ids_seen / self.rows_fetched if self.rows_fetched \
            else 1.0

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    # -- lookup -------------------------------------------------------------
    def lookup(self, ids) -> torch.Tensor:
        """Rows for ``ids`` as a device tensor ``[N, dim]`` (any leading
        shape flattens; the caller reshapes). One unique-row gather +
        inverse permute under the dedup flag."""
        ids_np = self._check_ids(ids)
        self.pull_count += 1
        uniq, inv = self._dedup(ids_np)
        self.bytes_pulled += uniq.size * self.dim * 4
        rows = self._gather_unique(uniq)
        return rows[self._index(inv)]

    def _gather_unique(self, uniq: np.ndarray) -> torch.Tensor:
        mode = self._mode()
        n = self.num_shards
        u = self._index(uniq)
        if mode == "local":
            RECSYS_STATS["auto_lookups"] += 1
            return self.data[0, u]
        RECSYS_STATS["manual_lookups"] += 1
        from ..distributed.collective import ReduceOp, all_reduce
        own = (u % n) == self.shard
        local = torch.clamp(u // n, 0, self._rows_per_shard - 1)
        rows = torch.where(own[:, None], self.data[0, local], 0.0)
        return all_reduce(rows, ReduceOp.SUM, group=self._group)

    # -- sparse update ------------------------------------------------------
    def apply_grads(self, ids, grads) -> None:
        """Sparse optimizer step: accumulate duplicate-id gradients over
        the unique set (SparseTable push semantics, np accumulation
        order), then the row-wise adagrad/sgd update runs ON the shard
        that owns each row — optimizer state never crosses the mesh."""
        ids_np = self._check_ids(ids)
        grads_np = np.asarray(grads, np.float32).reshape(
            ids_np.size, self.dim)
        self.push_count += 1
        self.bytes_pushed += grads_np.nbytes
        uniq, inv = np.unique(ids_np, return_inverse=True)
        acc = np.zeros((uniq.size, self.dim), np.float32)
        np.add.at(acc, inv, grads_np)
        self._update_unique(uniq.astype(np.int64), acc)

    def _update_unique(self, uniq: np.ndarray, acc: np.ndarray) -> None:
        mode = self._mode()
        n = self.num_shards
        if mode == "local":
            RECSYS_STATS["auto_updates"] += 1
        else:
            RECSYS_STATS["manual_updates"] += 1
            own = (uniq % n) == self.shard
            uniq, acc = uniq[own], acc[own]
        local = self._index(uniq // n)
        a = torch.from_numpy(acc).to(self.device)
        # the ids are unique, so the indexed writes meet no duplicates
        if self.optimizer == "adagrad":
            g2 = self.g2[0, local] + (a ** 2).mean(dim=1)
            self.g2[0, local] = g2
            denom = torch.sqrt(g2)[:, None] + 1e-10
            self.data[0, local] = self.data[0, local] + (-self.lr * a / denom)
        else:
            self.data[0, local] = self.data[0, local] + (-self.lr * a)

    # -- SparseTable protocol (host arrays) ---------------------------------
    def pull(self, ids) -> np.ndarray:
        return self.lookup(ids).cpu().numpy()

    def push(self, ids, grads) -> None:
        self.apply_grads(ids, grads)

    # -- accounting / attribution -------------------------------------------
    def device_arrays(self):
        """The tensors the table holds on its device (the census of
        :func:`paddle_tpu_torch.recsys.publish_table_hbm`)."""
        out = [self.data]
        if self.optimizer == "adagrad":
            out.append(self.g2)
        return out

    def hbm_bytes(self) -> int:
        return sum(int(a.nbytes) for a in self.device_arrays()
                   if a is not None)

    # -- checkpoint ---------------------------------------------------------
    def _blocks(self):
        """The JAX ``[n, R, D]`` data and ``[n, R]`` g2 as host arrays
        (gathered over the ps group on a ps mesh)."""
        if self._group is None:
            return self.data.cpu().numpy(), self.g2.cpu().numpy()
        from ..distributed.collective import all_gather
        data = all_gather(self.data[0].contiguous(), group=self._group)
        g2 = all_gather(self.g2[0].contiguous(), group=self._group)
        return data.cpu().numpy(), g2.cpu().numpy()

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Global-row-order dense arrays (mesh-layout-independent: a
        checkpoint written on ps=8 restores onto ps=2 or ps=1)."""
        arr, g2 = self._blocks()
        ids = np.arange(self.num_rows)
        out = {"data": arr[ids % self.num_shards, ids // self.num_shards]}
        if self.optimizer == "adagrad":
            out["g2"] = g2[ids % self.num_shards, ids // self.num_shards]
        return out

    def load_state_dict(self, state) -> None:
        data = np.asarray(state["data"], np.float32)
        if data.shape != (self.num_rows, self.dim):
            raise ValueError(
                f"state_dict shape {data.shape} != table "
                f"{(self.num_rows, self.dim)}")
        n, R, s = self.num_shards, self._rows_per_shard, self.shard
        mine = np.arange(s, self.num_rows, n)
        block = np.zeros((1, R, self.dim), np.float32)
        block[0, mine // n] = data[mine]
        g2 = np.zeros((1, R), np.float32)
        if "g2" in state and self.optimizer == "adagrad":
            g2[0, mine // n] = np.asarray(state["g2"], np.float32)[mine]
        self.data = torch.from_numpy(block).to(self.device)
        self.g2 = torch.from_numpy(g2).to(self.device)
