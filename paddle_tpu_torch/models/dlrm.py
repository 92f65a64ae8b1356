"""DLRM: the deep-learning recommendation model (Naumov et al., 2019).

Counterpart of ``paddle_tpu/models/dlrm.py``, the flagship consumer of
:mod:`paddle_tpu_torch.recsys`:

- dense features -> bottom MLP -> one ``embedding_dim`` vector;
- each sparse slot's id -> an embedding TABLE lookup. The tables are
  SparseTable-protocol objects (host :class:`SparseTable`,
  :class:`SSDSparseTable`, :class:`~paddle_tpu_torch.recsys.
  TieredEmbeddingTable`, :class:`~paddle_tpu_torch.recsys.
  ShardedEmbeddingTable`), NOT dense parameters: dense optimizers skip
  them, and gradients stream into the tables from the backward pass (the
  PS push path), exactly like ``DistributedEmbedding``;
- pairwise-dot feature interaction over the stacked vectors (upper
  triangle), concatenated with the bottom output;
- top MLP -> one click logit.

The lookups of one forward form ONE autograd node
(:class:`~paddle_tpu_torch.distributed.ps.TableRows`) on the model's
anchor. Its backward pushes the slots in reverse order, as the JAX tape
runs its per-slot nodes: with one table shared by every slot each
adagrad push changes the state the next reads, so the order shows in the
result. The dense parameters keep the JAX names and layouts
(``bottom.0.weight [in, out]``), so ``models.load_jax_weights`` copies a
JAX DLRM's dense weights; the tables carry across through their
``state_dict``.

The embedding phase is timed per forward (``last_timings``) so the
serving engine can attribute lookup latency separately from MLP
compute; on the card the device is synchronised before each clock read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn as tnn

from .. import nn
from ..core.device import DeviceLike, resolve_device
from ..core.random import make_generator
from ..distributed.ps import TableRows, host_grad, make_anchor
from ..nn import functional as F
from ..nn.layer import Layer

__all__ = ["DLRMConfig", "TableEmbedding", "DLRM", "dlrm_tiny"]


class TableEmbedding(Layer):
    """Embedding over a SparseTable-protocol table with a device-tensor
    fast path: forward uses ``table.lookup`` (device rows, no host round
    trip for device-resident tables) when present, else ``table.pull``;
    backward pushes the row gradients into the table (the PS push)."""

    def __init__(self, table, device: DeviceLike = None):
        super().__init__()
        self.table = table
        self.embedding_dim = int(table.dim)
        self.device = resolve_device(device)
        self._anchor = make_anchor()

    def rows(self, ids_np: np.ndarray):
        """(pull, push) closures of one lookup of ``ids_np``: ``pull()``
        returns the rows ``ids_np.shape + (dim,)`` on this module's
        device, ``push(g)`` pushes their gradient into the table."""
        flat = ids_np.reshape(-1)
        shape = ids_np.shape + (self.embedding_dim,)
        table = self.table

        def pull():
            lookup = getattr(table, "lookup", None)
            if lookup is not None:
                rows = lookup(flat)
            else:
                rows = torch.from_numpy(np.ascontiguousarray(
                    table.pull(flat), np.float32))
            return rows.to(self.device).reshape(shape)

        def push(g):
            table.push(flat, host_grad(g))

        return pull, push

    def forward(self, ids) -> torch.Tensor:
        pull, push = self.rows(_host_ids(ids))
        (out,) = TableRows.apply(self._anchor, [pull], [push])
        return out


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


@dataclass
class DLRMConfig:
    num_dense: int = 4
    num_sparse: int = 8
    #: one vocab for every slot, or a per-slot list
    vocab_sizes: Union[int, Sequence[int]] = 10_000
    embedding_dim: int = 16
    bottom_mlp: Tuple[int, ...] = (32,)
    top_mlp: Tuple[int, ...] = (32,)

    def vocab_list(self) -> List[int]:
        v = self.vocab_sizes
        if isinstance(v, (int, np.integer)):
            return [int(v)] * self.num_sparse
        if len(v) != self.num_sparse:
            raise ValueError("vocab_sizes must match num_sparse")
        return [int(x) for x in v]


def _mlp(sizes: Sequence[int], final_act: bool, device) -> nn.Sequential:
    layers: list = []
    for i in range(len(sizes) - 1):
        layers.append(nn.Linear(sizes[i], sizes[i + 1], device=device))
        if final_act or i < len(sizes) - 2:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class DLRM(Layer):
    """``forward(dense [B, num_dense], ids [B, num_sparse]) -> logits
    [B]``. ``tables`` injects the embedding stores (one per sparse
    slot, or one shared); default = per-slot host ``SparseTable``.
    Built on ``device`` (the card unless ``device="cpu"``) with the
    dense weights drawn from ``seed`` (XavierUniform weights, zero
    biases, the JAX defaults)."""

    def __init__(self, config: DLRMConfig, tables: Optional[list] = None,
                 table_optimizer: str = "adagrad", table_lr: float = 0.05,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.device = dev
        self.cfg = config
        vocabs = config.vocab_list()
        D = config.embedding_dim
        if tables is None:
            from ..distributed.ps import SparseTable
            tables = [SparseTable(v, D, optimizer=table_optimizer,
                                  lr=table_lr, seed=seed + f)
                      for f, v in enumerate(vocabs)]
        elif len(tables) == 1 and config.num_sparse > 1:
            tables = list(tables) * config.num_sparse   # one shared table
        if len(tables) != config.num_sparse:
            raise ValueError(
                f"need {config.num_sparse} tables (or 1 shared), got "
                f"{len(tables)}")
        for t in tables:
            if int(t.dim) != D:
                raise ValueError("every table's dim must equal "
                                 f"embedding_dim={D}")
        self.embeddings = tnn.ModuleList(
            [TableEmbedding(t, device=dev) for t in tables])
        self.bottom = _mlp((config.num_dense,) + tuple(config.bottom_mlp)
                           + (D,), final_act=True, device=dev)
        F_feat = config.num_sparse + 1
        self._triu = np.triu_indices(F_feat, k=1)
        n_pairs = len(self._triu[0])
        self.top = _mlp((D + n_pairs,) + tuple(config.top_mlp) + (1,),
                        final_act=False, device=dev)
        self._pair_idx = torch.from_numpy(
            (self._triu[0] * F_feat + self._triu[1]).astype(np.int64)).to(dev)
        self._anchor = make_anchor()
        g = make_generator(seed, dev)
        with torch.no_grad():
            for m in (*self.bottom, *self.top):
                if isinstance(m, nn.Linear):
                    m.reset_parameters(g)
        #: wall-clock split of the last forward — the serving engine's
        #: lookup-vs-rank latency attribution
        self.last_timings = {"lookup_s": 0.0, "mlp_s": 0.0}

    @property
    def tables(self) -> list:
        return [e.table for e in self.embeddings]

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def forward(self, dense, ids) -> torch.Tensor:
        t0 = self._clock()
        ids_np = _host_ids(ids)
        if ids_np.ndim != 2 or ids_np.shape[1] != self.cfg.num_sparse:
            raise ValueError(
                f"ids must be [B, {self.cfg.num_sparse}], got "
                f"{ids_np.shape}")
        pulls, pushes = zip(*(emb.rows(ids_np[:, f])
                              for f, emb in enumerate(self.embeddings)))
        embs = TableRows.apply(self._anchor, pulls, pushes)
        t1 = self._clock()
        if not isinstance(dense, torch.Tensor):
            dense = torch.from_numpy(np.ascontiguousarray(dense, np.float32))
        x = self.bottom(dense.to(self.device))
        z = torch.stack([x, *embs], dim=1)              # [B, F+1, D]
        inter = torch.matmul(z, z.transpose(1, 2))
        flat = inter.reshape(inter.shape[0], -1)
        pairs = flat.index_select(1, self._pair_idx)
        top_in = torch.cat([x, pairs], dim=-1)
        logits = self.top(top_in).reshape(-1)
        t2 = self._clock()
        self.last_timings = {"lookup_s": t1 - t0, "mlp_s": t2 - t1}
        return logits

    def loss(self, dense, ids, labels) -> torch.Tensor:
        logits = self(dense, ids)
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.ascontiguousarray(labels,
                                                           np.float32))
        return F.binary_cross_entropy_with_logits(
            logits, labels.to(self.device))


def dlrm_tiny(**over) -> DLRMConfig:
    """Test-scale config (the gpt_tiny convention)."""
    kw = dict(num_dense=4, num_sparse=4, vocab_sizes=512,
              embedding_dim=8, bottom_mlp=(16,), top_mlp=(16,))
    kw.update(over)
    return DLRMConfig(**kw)
