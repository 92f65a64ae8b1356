"""Giant-embedding recommender subsystem.

Counterpart of ``paddle_tpu/recsys/``: embedding tables of many rows,
updated sparsely, pulled at serving deadlines, with the DLRM model in
:mod:`paddle_tpu_torch.models.dlrm`.

- :class:`~.sharded_table.ShardedEmbeddingTable`: rows on the device,
  row-sharded over the ranks of a ``ps`` mesh axis (a ps rank is a
  process: each holds its shard, a lookup is a masked gather plus one
  ``all_reduce``), dedup lookups and adagrad state beside its rows;
- :class:`~.tiering.TieredEmbeddingTable`: a hot tier on the device in
  front of a host / SSD backing table (admission by access frequency,
  eviction by LRU, the JAX package's host bookkeeping);
- :class:`~.data.CriteoSynthetic`: the seeded power-law workload;
- :class:`~.serving.RecsysEngine`: online lookup and ranking under
  bounded-queue admission, deadlines and overload shedding;
- :mod:`~.checkpoint`: table save / restore through the atomic
  checkpoint manifest, in the JAX package's snapshot format.

Where the JAX package falls back to its GSPMD auto path on a ps mesh
(``FLAGS_recsys_sharded_lookup`` off), the port has no counterpart, since
its ps ranks are processes: :func:`note_recsys_fallback` raises, and
``RECSYS_STATS["fallbacks"]`` stays 0. :func:`publish_table_hbm` counts
the tensors each registered table still holds, where the JAX package
checks its arrays against ``jax.live_arrays()``.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["RECSYS_STATS", "reset_recsys_stats", "note_recsys_fallback",
           "register_table", "tables", "publish_table_hbm", "reset",
           "ShardedEmbeddingTable", "TieredEmbeddingTable",
           "CriteoSynthetic", "RecsysEngine", "RecsysRequest",
           "RecsysServingConfig", "save_tables", "load_tables"]

#: explicit mesh lookups/updates, local (one-shard) dispatches, and
#: fallbacks (always 0: the port refuses where JAX falls back)
RECSYS_STATS = {"manual_lookups": 0, "auto_lookups": 0,
                "manual_updates": 0, "auto_updates": 0, "fallbacks": 0}


def reset_recsys_stats() -> None:
    for k in RECSYS_STATS:
        RECSYS_STATS[k] = 0


def note_recsys_fallback(reason: str, detail: str = "") -> None:
    """Where the JAX table degrades to its GSPMD auto path on a ps mesh:
    the port has none (each ps rank holds only its shard), so it
    raises."""
    raise NotImplementedError(
        f"the recsys sharded lookup cannot run here (reason: {reason}"
        f"{'; ' + detail if detail else ''}): the JAX package falls back "
        "to its GSPMD auto path; the port's ps ranks are processes and "
        "have no auto path. Leave FLAGS_recsys_sharded_lookup on, or the "
        "ps axis at 1")


# ---------------------------------------------------------------------------
# Table registry: the HBM attribution walk names every live table through
# here (reset() clears it between tests).
# ---------------------------------------------------------------------------

_TABLES: "Dict[str, object]" = {}


def register_table(name: str, table) -> None:
    _TABLES[name] = table


def tables() -> Dict[str, object]:
    return dict(_TABLES)


def _held_bytes(arrays) -> int:
    """Bytes of the tensors among ``arrays`` (a dropped one, None,
    counts 0)."""
    return sum(int(a.nbytes) for a in arrays if isinstance(a, torch.Tensor))


def publish_table_hbm(registry=None) -> Dict[str, int]:
    """Per-table device-memory attribution: every registered table
    reports the bytes of the tensors its hot / sharded arrays still hold
    (a table whose arrays were dropped attributes 0, not its configured
    capacity). Publishes ``recsys_table_hbm_bytes{table=...}`` gauges;
    returns {name: bytes}."""
    out: Dict[str, int] = {}
    for name, t in _TABLES.items():
        out[name] = _held_bytes(getattr(t, "device_arrays", lambda: [])())
    if out:
        from ..monitor import get_registry
        g = (registry or get_registry()).gauge(
            "recsys_table_hbm_bytes",
            "device bytes pinned by a registered embedding table's "
            "hot/sharded arrays (live-buffer identity census)")
        for name, b in out.items():
            g.set(b, table=name)
    return out


def reset() -> None:
    """Test isolation: clear table registry + stats, close tables that
    own temp SSD files, and drop any live recsys serving engines."""
    for t in _TABLES.values():
        close = getattr(t, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
    _TABLES.clear()
    reset_recsys_stats()
    from .serving import reset_engines
    reset_engines()


from .sharded_table import ShardedEmbeddingTable  # noqa: E402
from .tiering import TieredEmbeddingTable  # noqa: E402
from .data import CriteoSynthetic  # noqa: E402
from .serving import (RecsysEngine, RecsysRequest,  # noqa: E402
                      RecsysServingConfig)
from .checkpoint import load_tables, save_tables  # noqa: E402
