"""SSD (disk-backed) sparse table: the PS industrial tail.

Counterpart of ``paddle_tpu/distributed/ps/ssd_table.py``, a copy
(numpy and a log file): rows, optimizer state and the log format are
the JAX package's.

reference parity: paddle/fluid/distributed/table/ssd_sparse_table.h:21 —
a sparse table whose cold rows live on local SSD (rocksdb in the
reference) behind an in-memory hot cache, so embedding tables larger
than host RAM still serve pull/push at memory speed for the hot set.

TPU-native redesign: a log-structured append-only file + an in-memory
offset index replaces rocksdb (no external deps): the newest version of
a row is wherever it was last appended; eviction appends the row and
drops it from the hot cache; `compact()` rewrites only live offsets.
Rows are materialized LAZILY on first touch with a per-row deterministic
initializer (hash-seeded), so a 10^9-row table costs nothing until ids
arrive — the reference's SSD table is lazy the same way.

Protocol-compatible with :class:`SparseTable` (pull/push/state_dict), so
`DistributedEmbedding(table=SSDSparseTable(...))` works unchanged.
"""

from __future__ import annotations

import os
import struct
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

__all__ = ["SSDSparseTable"]

_HDR = struct.Struct("<qf")          # row_id:int64, g2:float32


class SSDSparseTable:
    """Disk-backed sparse embedding shard with an LRU hot cache.

    ``cache_rows`` caps host-memory residency; everything beyond it
    spills to ``path`` (a log-structured file). The pull/push/optimizer
    semantics match :class:`SparseTable` (adagrad | sgd, duplicate-id
    gradient accumulation before the update)."""

    def __init__(self, num_rows: int, dim: int, cache_rows: int = 100_000,
                 path: Optional[str] = None, optimizer: str = "adagrad",
                 lr: float = 0.05, shard_id: int = 0, num_shards: int = 1,
                 seed: int = 0):
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unknown PS optimizer {optimizer!r}")
        self.num_rows = num_rows
        self.dim = dim
        self.cache_rows = max(1, int(cache_rows))
        self.optimizer = optimizer
        self.lr = lr
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self._rec = _HDR.size + 4 * dim
        if path is None:
            import tempfile
            fd, path = tempfile.mkstemp(prefix="ps_ssd_", suffix=".log")
            os.close(fd)
            self._own_path = True
        else:
            self._own_path = False
        self.path = path
        self._log = open(path, "a+b")
        self._log.seek(0, os.SEEK_END)
        # hot cache: row_id -> (vec[dim] f32, g2 float); LRU order
        self._cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._index: Dict[int, int] = {}      # row_id -> log offset
        self.pull_count = 0
        self.push_count = 0
        self.evict_count = 0
        # per-source row reads: the host-cache/SSD split a tier manager
        # (paddle_tpu_torch.recsys.tiering) surfaces as host vs ssd hit rates
        self.cache_hit_count = 0
        self.log_read_count = 0
        self.lazy_init_count = 0

    # -- row lifecycle -----------------------------------------------------
    def _init_row(self, rid: int) -> np.ndarray:
        """Deterministic lazy init: same row always initializes the same
        regardless of touch order / cache state (the eager SparseTable
        cannot promise that across shard counts; a disk table must)."""
        rng = np.random.default_rng((self.seed * 0x9E3779B1 + rid)
                                    & 0xFFFFFFFF)
        scale = 1.0 / np.sqrt(self.dim)
        return rng.uniform(-scale, scale, (self.dim,)).astype(np.float32)

    def _read_row(self, offset: int):
        self._log.seek(offset)
        buf = self._log.read(self._rec)
        rid, g2 = _HDR.unpack_from(buf)
        vec = np.frombuffer(buf, np.float32, self.dim, _HDR.size).copy()
        return rid, vec, g2

    def _append_row(self, rid: int, vec: np.ndarray, g2: float) -> int:
        self._log.seek(0, os.SEEK_END)
        offset = self._log.tell()
        self._log.write(_HDR.pack(rid, g2))
        self._log.write(np.ascontiguousarray(vec, np.float32).tobytes())
        return offset

    def _evict_to_cap(self):
        while len(self._cache) > self.cache_rows:
            rid, (vec, g2) = self._cache.popitem(last=False)   # LRU
            self._index[rid] = self._append_row(rid, vec, g2)
            self.evict_count += 1

    def _load(self, rid: int):
        """Row into the hot cache (disk read or lazy init); returns the
        cache entry and refreshes recency."""
        hit = self._cache.get(rid)
        if hit is not None:
            self.cache_hit_count += 1
            self._cache.move_to_end(rid)
            return hit
        off = self._index.get(rid)
        if off is not None:
            self.log_read_count += 1
            stored_rid, vec, g2 = self._read_row(off)
            assert stored_rid == rid, "corrupt SSD table index"
        else:
            self.lazy_init_count += 1
            vec, g2 = self._init_row(rid), 0.0
        self._cache[rid] = (vec, g2)
        self._evict_to_cap()
        return self._cache.get(rid) or (vec, g2)

    # -- SparseTable protocol ---------------------------------------------
    def _local(self, ids: np.ndarray) -> np.ndarray:
        if self.num_shards > 1:
            if not ((ids % self.num_shards) == self.shard_id).all():
                raise ValueError("ids routed to the wrong shard")
            return ids // self.num_shards
        return ids

    def pull(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        local = self._local(ids)
        self.pull_count += 1
        out = np.empty((len(local), self.dim), np.float32)
        for i, rid in enumerate(local):
            out[i] = self._load(int(rid))[0]
        return out

    def push(self, ids, grads) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        local = self._local(ids)
        uniq, inv = np.unique(local, return_inverse=True)
        acc = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(acc, inv, grads)
        for i, rid in enumerate(uniq):
            rid = int(rid)
            vec, g2 = self._load(rid)
            g = acc[i]
            if self.optimizer == "adagrad":
                g2 = g2 + float((g ** 2).mean())
                vec = vec - self.lr * g / (np.sqrt(g2) + 1e-10)
            else:
                vec = vec - self.lr * g
            self._cache[rid] = (vec.astype(np.float32), g2)
        self.push_count += 1

    # -- raw row access (tier promotion/demotion; no optimizer step) -------
    def read_rows(self, ids):
        """(vecs [n, dim], g2 [n]) without cache promotion or pull
        accounting — the tier manager's raw read (``_load_cold`` walk,
        so a promotion scan never thrashes the hot cache)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        local = self._local(ids)
        vecs = np.empty((len(local), self.dim), np.float32)
        g2 = np.empty((len(local),), np.float32)
        for i, rid in enumerate(local):
            v, g = self._load_cold(int(rid))
            vecs[i], g2[i] = v, g
        return vecs, g2

    def write_rows(self, ids, vecs, g2=None) -> None:
        """Overwrite rows (and adagrad state) verbatim — the tier
        manager's demotion write-back. NOT a push: no gradient math."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        local = self._local(ids)
        vecs = np.asarray(vecs, np.float32).reshape(len(local), self.dim)
        g2 = (np.zeros(len(local), np.float32) if g2 is None
              else np.asarray(g2, np.float32).reshape(-1))
        for i, rid in enumerate(local):
            self._cache[int(rid)] = (vecs[i].copy(), float(g2[i]))
        self._evict_to_cap()

    # -- maintenance -------------------------------------------------------
    @property
    def resident_rows(self) -> int:
        return len(self._cache)

    @property
    def spilled_rows(self) -> int:
        return len([r for r in self._index if r not in self._cache])

    def log_bytes(self) -> int:
        self._log.seek(0, os.SEEK_END)
        return self._log.tell()

    def compact(self):
        """Rewrite the log keeping only each row's LIVE version (the
        reference compaction is rocksdb's; a log-structured file needs an
        explicit pass)."""
        tmp_path = self.path + ".compact"
        with open(tmp_path, "wb") as tmp:
            new_index = {}
            for rid, off in self._index.items():
                if rid in self._cache:
                    continue                   # hot copy is newer
                _, vec, g2 = self._read_row(off)
                new_index[rid] = tmp.tell()
                tmp.write(_HDR.pack(rid, g2))
                tmp.write(vec.tobytes())
        self._log.close()
        os.replace(tmp_path, self.path)
        self._log = open(self.path, "a+b")
        self._index = new_index

    # -- checkpoint (SparseTable-compatible surface) -----------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """All TOUCHED rows (hot + spilled) as dense arrays keyed by id —
        round-trips through load_state_dict; untouched rows re-derive
        from the deterministic initializer."""
        rows, vecs, g2s = [], [], []
        for rid in sorted(set(self._cache) | set(self._index)):
            vec, g2 = self._load_cold(rid)
            rows.append(rid)
            vecs.append(vec)
            g2s.append(g2)
        return {"row_ids": np.asarray(rows, np.int64),
                "data": (np.stack(vecs) if vecs
                         else np.zeros((0, self.dim), np.float32)),
                "g2": np.asarray(g2s, np.float32)}

    def _load_cold(self, rid: int):
        """Read a row WITHOUT promoting it into the cache (checkpoint
        walks must not thrash the hot set)."""
        hit = self._cache.get(rid)
        if hit is not None:
            return hit
        off = self._index.get(rid)
        if off is not None:
            _, vec, g2 = self._read_row(off)
            return vec, g2
        return self._init_row(rid), 0.0

    def load_state_dict(self, state):
        ids = np.asarray(state["row_ids"], np.int64)
        data = np.asarray(state["data"], np.float32)
        g2 = np.asarray(state.get("g2",
                                  np.zeros(len(ids), np.float32)),
                        np.float32)
        self._cache.clear()
        self._index.clear()
        self._log.truncate(0)
        for i, rid in enumerate(ids):
            self._cache[int(rid)] = (data[i].copy(), float(g2[i]))
            self._evict_to_cap()

    def save(self, dirname: str):
        os.makedirs(dirname, exist_ok=True)
        np.savez(os.path.join(dirname, f"ssd_shard_{self.shard_id}.npz"),
                 **self.state_dict())

    def load(self, dirname: str):
        with np.load(os.path.join(
                dirname, f"ssd_shard_{self.shard_id}.npz")) as z:
            self.load_state_dict({k: z[k] for k in z.files})

    def close(self):
        try:
            self._log.close()
        finally:
            if self._own_path and os.path.exists(self.path):
                os.unlink(self.path)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
