"""Hierarchical embedding tiering: device hot tier <- host <- SSD.

Counterpart of ``paddle_tpu/recsys/tiering.py``. Recsys id traffic is
power-law: a tiny hot set takes almost every hit, so the hot rows live
at device speed while the long tail spills down the hierarchy
(ssd_sparse_table.h's memory cache over rocksdb; Monolith's hot-ID
tables).

:class:`TieredEmbeddingTable` owns a hot tier on its device (``_hot
[hot_rows, D]`` and ``_hot_g2 [hot_rows]``, tensors) in front of a
*backing* table: by default an :class:`~paddle_tpu_torch.distributed.
ps.SSDSparseTable`, whose LRU cache is the host tier and whose log file
is the SSD tier; any SparseTable-protocol object (a host
:class:`SparseTable`) makes a two-tier stack.

Residency, frequency, LRU, the dirty set, admission and eviction are
host Python, exactly as in the JAX package: row residency is exclusive
(a row lives in one tier; promotion moves it up with its optimizer state
through ``read_rows``, demotion writes it back verbatim through
``write_rows``), a row is promoted after ``admit_after`` pulls, eviction
is LRU over the hot slots and only a row updated while hot (dirty) is
written back. Pushes keep SparseTable's semantics: duplicate-id
gradients accumulate on the host over the unique set (``np.add.at``),
then the hot rows take the adagrad / sgd update on the device, their
unique slots indexed once each.

Device traffic: a pull gathers its hot rows on the device before any
promotion writes a slot; :meth:`lookup` assembles hot and cold rows on
the device (one host-to-device copy of the cold rows) and returns
straight off the hot tier when every unique id is hot. A promotion batch
larger than the free slots is laid out on the host first (which slot
each row takes, which resident dirty rows it demotes), so its demotions
read the device once and its rows land in one indexed write: the same
slots, values and write-backs as the JAX row-by-row commit.

Per-tier hit / miss / promotion counters stream through ``monitor/``
(:meth:`publish_tier_metrics`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

__all__ = ["TieredEmbeddingTable"]


class TieredEmbeddingTable:
    """SparseTable-protocol table whose hot rows live in device memory.

    ``hot_rows`` caps device residency; ``admit_after`` is the access
    frequency that earns a row promotion (1 = admit on first touch).
    """

    def __init__(self, num_rows: int, dim: int, hot_rows: int = 4096,
                 backing=None, host_rows: Optional[int] = None,
                 admit_after: int = 2, optimizer: str = "adagrad",
                 lr: float = 0.05, seed: int = 0, name: str = "table",
                 device: DeviceLike = None):
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unknown PS optimizer {optimizer!r}")
        self.device = resolve_device(device)
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.hot_rows = max(1, int(hot_rows))
        self.admit_after = max(1, int(admit_after))
        self.optimizer = optimizer
        self.lr = float(lr)
        self.name = name
        self._own_backing = backing is None
        if backing is None:
            from ..distributed.ps import SSDSparseTable
            backing = SSDSparseTable(
                num_rows, dim,
                cache_rows=host_rows if host_rows is not None
                else max(4 * self.hot_rows, 1024),
                optimizer=optimizer, lr=lr, seed=seed)
        if getattr(backing, "optimizer", optimizer) != optimizer or \
                getattr(backing, "lr", lr) != lr:
            raise ValueError(
                "tier optimizer/lr must match the backing table's (a "
                "row's update rule cannot depend on which tier it is in)")
        self.backing = backing
        self._new_hot()
        self._slot_of: Dict[int, int] = {}
        self._lru: "OrderedDict[int, int]" = OrderedDict()   # rid -> slot
        self._free: List[int] = list(range(self.hot_rows - 1, -1, -1))
        self._freq: Dict[int, int] = {}
        #: hot rows updated since promotion — only these need the
        #: demotion write-back (a clean row's backing copy is current)
        self._dirty: set = set()
        self.pull_count = 0
        self.push_count = 0
        self.stats = {"hbm_hits": 0, "host_hits": 0, "ssd_reads": 0,
                      "lazy_inits": 0, "promotions": 0, "demotions": 0,
                      "evictions": 0}
        self._published = dict(self.stats)
        self.bytes_pulled = 0
        self.bytes_pushed = 0
        self.ids_seen = 0
        self.rows_fetched = 0

    def _new_hot(self) -> None:
        self._hot = torch.zeros((self.hot_rows, self.dim),
                                dtype=torch.float32, device=self.device)
        self._hot_g2 = torch.zeros((self.hot_rows,), dtype=torch.float32,
                                   device=self.device)

    def _dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    # -- hot-tier bookkeeping ----------------------------------------------
    def _touch(self, rid: int) -> None:
        self._lru.move_to_end(rid)

    def _backing_read_stats(self):
        b = self.backing
        return (getattr(b, "cache_hit_count", None),
                getattr(b, "log_read_count", 0),
                getattr(b, "lazy_init_count", 0))

    def _count_backing(self, before, n_rows: int) -> None:
        """Attribute ``n_rows`` backing fetches to host/ssd tiers from
        the backing table's read-source counters (SSDSparseTable); a
        plain host table attributes everything to the host tier."""
        after = self._backing_read_stats()
        if before[0] is None or after[0] is None:
            self.stats["host_hits"] += n_rows
            return
        self.stats["host_hits"] += after[0] - before[0]
        self.stats["ssd_reads"] += after[1] - before[1]
        self.stats["lazy_inits"] += after[2] - before[2]

    def _pop_lru(self):
        """Free the LRU hot slot's bookkeeping: (rid, slot, dirty). Only
        a DIRTY row (updated while hot) is demoted; a clean row's backing
        copy is still current, so its eviction costs no I/O. Hence
        evictions >= demotions."""
        rid, slot = self._lru.popitem(last=False)
        del self._slot_of[rid]
        self.stats["evictions"] += 1
        dirty = rid in self._dirty
        if dirty:
            self._dirty.discard(rid)
            self.stats["demotions"] += 1
        return rid, slot, dirty

    def _attribute_raw_reads(self, rids: List[int]) -> None:
        """Per-tier attribution of promotion reads (read_rows bypasses
        the backing's own counters): probe residency directly for an
        SSD backing; anything else attributes to the host tier."""
        b = self.backing
        cache = getattr(b, "_cache", None)
        index = getattr(b, "_index", None)
        if cache is None or getattr(b, "num_shards", 1) != 1:
            self.stats["host_hits"] += len(rids)
            return
        for rid in rids:
            if rid in cache:
                self.stats["host_hits"] += 1
            elif index is not None and rid in index:
                self.stats["ssd_reads"] += 1
            else:
                self.stats["lazy_inits"] += 1

    def _insert_hot(self, rids: List[int], vecs: np.ndarray,
                    g2: np.ndarray) -> None:
        """Install already-read rows into the hot tier, evicting LRU
        rows as needed, with the JAX row-by-row commit's result: each
        row takes a free slot or the LRU row's; a dirty row it evicts
        was resident before this batch (rows promoted here are clean),
        so its slot still holds its value when it is read back."""
        if not rids:
            return
        final: Dict[int, int] = {}          # slot -> index into rids
        demoted = []                        # (rid, slot), in order
        for i, rid in enumerate(rids):
            if self._free:
                slot = self._free.pop()
            else:
                old, slot, dirty = self._pop_lru()
                if dirty:
                    demoted.append((old, slot))
            self._slot_of[rid] = slot
            self._lru[rid] = slot
            final[slot] = i
        if demoted:
            idx = self._dev(np.asarray([s for _, s in demoted]), np.int64)
            back = self._hot[idx].cpu().numpy()
            back_g2 = self._hot_g2[idx].cpu().numpy()
            for j, (old, _) in enumerate(demoted):
                self.backing.write_rows([old], back[j].reshape(1, self.dim),
                                        back_g2[j].reshape(1))
        slots = np.fromiter(final.keys(), np.int64, len(final))
        src = np.fromiter(final.values(), np.int64, len(final))
        idx = self._dev(slots)
        self._hot[idx] = self._dev(np.asarray(vecs, np.float32)[src])
        self._hot_g2[idx] = self._dev(np.asarray(g2, np.float32)[src])
        self.stats["promotions"] += len(rids)

    def _age_freq(self) -> None:
        """Bound the frequency map: when it outgrows the hot set by a
        wide margin, drop the single-touch tail (power-law traffic
        keeps genuinely hot ids above 1)."""
        if len(self._freq) > max(65536, 16 * self.hot_rows):
            self._freq = {r: c for r, c in self._freq.items() if c > 1}

    # -- SparseTable protocol ----------------------------------------------
    def _fetch(self, ids_np: np.ndarray):
        """The JAX ``pull`` up to its result: (uniq rows' inverse, hot
        positions and their rows gathered on the device, cold positions
        and their host rows)."""
        self.pull_count += 1
        uniq, inv = np.unique(ids_np, return_inverse=True)
        self.ids_seen += ids_np.size
        self.rows_fetched += uniq.size
        self.bytes_pulled += uniq.size * self.dim * 4
        hot_ids, hot_pos, cold_ids, cold_pos = [], [], [], []
        for i, rid in enumerate(uniq):
            rid = int(rid)
            c = self._freq.get(rid, 0) + 1
            self._freq[rid] = c
            if rid in self._slot_of:
                self._touch(rid)
                hot_ids.append(rid)
                hot_pos.append(i)
            else:
                cold_ids.append(rid)
                cold_pos.append(i)
        hot_rows = None
        if hot_ids:
            self.stats["hbm_hits"] += len(hot_ids)
            slots = np.asarray([self._slot_of[r] for r in hot_ids],
                               np.int64)
            # gathered before a promotion below can take a slot
            hot_rows = self._hot[self._dev(slots)]
        cold = np.empty((len(cold_ids), self.dim), np.float32)
        if cold_ids:
            # promotion-bound rows are read ONCE via the raw surface
            # (value + optimizer state together) and never enter the
            # backing's LRU — a row moving to the device must not evict
            # a genuine host-tier row on its way out
            at = {r: j for j, r in enumerate(cold_ids)}
            promote = [r for r in cold_ids
                       if self._freq[r] >= self.admit_after]
            stay = [r for r in cold_ids
                    if self._freq[r] < self.admit_after]
            if stay:
                before = self._backing_read_stats()
                cold[[at[r] for r in stay]] = self.backing.pull(stay)
                self._count_backing(before, len(stay))
            if promote:
                self._attribute_raw_reads(promote)
                vecs, g2 = self.backing.read_rows(promote)
                cold[[at[r] for r in promote]] = vecs
                self._insert_hot(promote, vecs, g2)
        self._age_freq()
        return uniq.size, inv, hot_pos, hot_rows, cold_pos, cold

    def pull(self, ids) -> np.ndarray:
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        n, inv, hot_pos, hot_rows, cold_pos, cold = self._fetch(ids_np)
        out = np.empty((n, self.dim), np.float32)
        if hot_pos:
            out[hot_pos] = hot_rows.cpu().numpy()
        if cold_pos:
            out[cold_pos] = cold
        return out[inv]

    def lookup(self, ids) -> torch.Tensor:
        """Device-tensor lookup; when EVERY unique id is hot the rows
        come straight off the device tensor — the hot set serves at
        device speed with no host round-trip."""
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        uniq, inv = np.unique(ids_np, return_inverse=True)
        if all(int(r) in self._slot_of for r in uniq):
            self.pull_count += 1
            self.ids_seen += ids_np.size
            self.rows_fetched += uniq.size
            self.bytes_pulled += uniq.size * self.dim * 4
            self.stats["hbm_hits"] += uniq.size
            slots = np.empty(uniq.size, np.int64)
            for i, rid in enumerate(uniq):
                rid = int(rid)
                self._freq[rid] = self._freq.get(rid, 0) + 1
                self._touch(rid)
                slots[i] = self._slot_of[rid]
            return self._hot[self._dev(slots[inv])]
        n, inv, hot_pos, hot_rows, cold_pos, cold = self._fetch(ids_np)
        if not hot_pos:
            return self._dev(cold[inv])
        out = torch.empty((n, self.dim), dtype=torch.float32,
                          device=self.device)
        out[self._dev(np.asarray(hot_pos), np.int64)] = hot_rows
        if cold_pos:
            out[self._dev(np.asarray(cold_pos), np.int64)] = self._dev(cold)
        return out[self._dev(inv, np.int64)]

    def push(self, ids, grads) -> None:
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        grads_np = np.asarray(grads, np.float32).reshape(
            ids_np.size, self.dim)
        self.push_count += 1
        self.bytes_pushed += grads_np.nbytes
        uniq, inv = np.unique(ids_np, return_inverse=True)
        acc = np.zeros((uniq.size, self.dim), np.float32)
        np.add.at(acc, inv, grads_np)
        hot_slots, hot_rows, cold_ids, cold_rows = [], [], [], []
        for i, rid in enumerate(uniq):
            rid = int(rid)
            slot = self._slot_of.get(rid)
            if slot is not None:
                self._touch(rid)
                self._dirty.add(rid)      # backing copy is now stale
                hot_slots.append(slot)
                hot_rows.append(i)
            else:
                cold_ids.append(rid)
                cold_rows.append(i)
        if hot_slots:
            # unique ids hold unique slots: the indexed writes meet no
            # duplicates, so the result does not depend on order
            idx = self._dev(np.asarray(hot_slots), np.int64)
            a = self._dev(acc[hot_rows])
            if self.optimizer == "adagrad":
                g2 = self._hot_g2[idx] + (a ** 2).mean(dim=1)
                self._hot_g2[idx] = g2
                denom = torch.sqrt(g2)[:, None] + 1e-10
                self._hot[idx] = self._hot[idx] + (-self.lr * a / denom)
            else:
                self._hot[idx] = self._hot[idx] + (-self.lr * a)
        if cold_ids:
            self.backing.push(cold_ids, acc[cold_rows])

    # -- accounting / reporting --------------------------------------------
    @property
    def dedup_ratio(self) -> float:
        """Mean ids-per-fetched-row since construction (1.0 = no
        reuse; power-law traffic sits well above it)."""
        return self.ids_seen / self.rows_fetched if self.rows_fetched \
            else 1.0

    @property
    def resident_hot_rows(self) -> int:
        return len(self._slot_of)

    def device_arrays(self):
        out = [self._hot]
        if self.optimizer == "adagrad":
            out.append(self._hot_g2)
        return out

    def hbm_bytes(self) -> int:
        return sum(int(a.nbytes) for a in self.device_arrays()
                   if a is not None)

    def tier_rows(self) -> Dict[str, int]:
        """Resident row counts per tier (occupancy view)."""
        out = {"hbm": len(self._slot_of)}
        b = self.backing
        if hasattr(b, "resident_rows"):
            out["host"] = int(b.resident_rows)
            out["ssd"] = int(getattr(b, "spilled_rows", 0))
        else:
            out["host"] = int(getattr(b, "num_rows", 0))
        return out

    def hit_rates(self) -> Dict[str, float]:
        """Per-tier share of row fetches, in percent (lazy inits count
        as SSD-tier reads: the row's home is the log)."""
        s = self.stats
        total = (s["hbm_hits"] + s["host_hits"] + s["ssd_reads"]
                 + s["lazy_inits"])
        if not total:
            return {"hbm": 0.0, "host": 0.0, "ssd": 0.0}
        return {"hbm": 100.0 * s["hbm_hits"] / total,
                "host": 100.0 * s["host_hits"] / total,
                "ssd": 100.0 * (s["ssd_reads"] + s["lazy_inits"]) / total}

    def publish_tier_metrics(self, registry=None) -> None:
        """Tier counters + occupancy gauges into the metrics registry
        (delta-increments since the last publish, so repeated calls are
        idempotent over the counter streams)."""
        from ..monitor import get_registry
        reg = registry or get_registry()
        s, p = self.stats, self._published
        hits = reg.counter(
            "recsys_tier_hits_total",
            "embedding row fetches by the tier that served them")
        for tier, keys in (("hbm", ("hbm_hits",)),
                           ("host", ("host_hits",)),
                           ("ssd", ("ssd_reads", "lazy_inits"))):
            delta = sum(s[k] - p[k] for k in keys)
            if delta:
                hits.inc(delta, table=self.name, tier=tier)
        for metric, key, help_ in (
                ("recsys_tier_promotions_total", "promotions",
                 "rows promoted into the HBM hot tier"),
                ("recsys_tier_demotions_total", "demotions",
                 "rows written back to the backing tier on eviction"),
                ("recsys_tier_evictions_total", "evictions",
                 "LRU evictions from the HBM hot tier")):
            delta = s[key] - p[key]
            if delta:
                reg.counter(metric, help_).inc(delta, table=self.name)
        self._published = dict(s)
        rows = reg.gauge("recsys_table_rows",
                         "resident embedding rows per tier")
        for tier, n in self.tier_rows().items():
            rows.set(n, table=self.name, tier=tier)
        rates = reg.gauge("recsys_tier_hit_pct",
                          "share of row fetches served per tier (%)")
        for tier, v in self.hit_rates().items():
            rates.set(v, table=self.name, tier=tier)

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Flat arrays: the hot tier verbatim + the backing state under
        a ``backing.`` prefix (round-trips through load_state_dict;
        residency — which rows are hot — survives the trip). Rows never
        UPDATED are not materialized anywhere (clean evictions skip the
        write-back), so they re-derive from the backing's deterministic
        initializer — restore onto a table built with the SAME seed,
        the SSDSparseTable state_dict contract."""
        hot_ids = np.asarray(list(self._lru.keys()), np.int64)
        slots = np.asarray([self._lru[int(r)] for r in hot_ids], np.int64)
        out = {"hot_ids": hot_ids,
               "hot_data": self._hot.cpu().numpy()[slots]
               if hot_ids.size else np.zeros((0, self.dim), np.float32),
               "hot_g2": self._hot_g2.cpu().numpy()[slots]
               if hot_ids.size else np.zeros((0,), np.float32)}
        for k, v in self.backing.state_dict().items():
            out[f"backing.{k}"] = v
        return out

    def load_state_dict(self, state) -> None:
        self.backing.load_state_dict(
            {k[len("backing."):]: v for k, v in state.items()
             if k.startswith("backing.")})
        self._new_hot()
        self._slot_of.clear()
        self._lru.clear()
        self._dirty.clear()
        self._free = list(range(self.hot_rows - 1, -1, -1))
        hot_ids = np.asarray(state.get("hot_ids", []), np.int64)
        data = np.asarray(state.get("hot_data",
                                    np.zeros((0, self.dim))), np.float32)
        g2 = np.asarray(state.get("hot_g2", np.zeros((0,))), np.float32)
        if hot_ids.size:
            n = min(hot_ids.size, self.hot_rows)
            slots = []
            for i in range(n):
                slot = self._free.pop()
                rid = int(hot_ids[i])
                self._slot_of[rid] = slot
                self._lru[rid] = slot
                slots.append(slot)
            idx = self._dev(np.asarray(slots), np.int64)
            self._hot[idx] = self._dev(data[:n])
            self._hot_g2[idx] = self._dev(g2[:n])
            # a restored hot row's backing copy (if any) predates the
            # snapshot's hot value — it must write back on eviction
            # regardless of future pushes
            self._dirty.update(int(r) for r in hot_ids[:n])
            if hot_ids.size > self.hot_rows:
                # a smaller hot budget demotes the overflow verbatim
                self.backing.write_rows(hot_ids[n:], data[n:], g2[n:])

    def close(self) -> None:
        if self._own_backing and hasattr(self.backing, "close"):
            self.backing.close()
