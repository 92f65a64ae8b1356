"""Sharded/tiered-table save & restore through the atomic checkpoint
manifest.

Counterpart of ``paddle_tpu/recsys/checkpoint.py``, a copy (numpy and
files): the snapshot layout, ``.npz`` files and manifest are the JAX
package's, so a snapshot written by either package loads in the other.

Every save stages per-table ``.npz`` files into ``tables_<n>.tmp`` and
commits through :func:`~paddle_tpu_torch.distributed.checkpoint._commit`
(fsync'd manifest with per-file sizes, atomic rename) — so a torn
write racing the commit (chaos site ``ckpt.write.torn``) is caught by
manifest verification and :func:`load_tables` falls back to the newest
VALID snapshot with a ``checkpoint_fallback`` flight event, exactly
like TrainStep checkpoints and drain snapshots. Table state is stored
in GLOBAL row order (``state_dict`` contracts), so a snapshot written
on one mesh layout restores onto another.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("paddle_tpu_torch.recsys")

__all__ = ["save_tables", "load_tables", "latest_valid_snapshot"]

_SNAP_RE = re.compile(r"^tables_(\d+)$")
STATE_NAME = "recsys_tables.json"


def _seq(name: str) -> int:
    m = _SNAP_RE.match(name)
    return int(m.group(1)) if m else 0


def save_tables(root: str, tables: Dict[str, object],
                step: Optional[int] = None) -> str:
    """Commit ``{name: table}`` state as ``<root>/tables_<n>``; returns
    the committed path. ``step`` defaults to the next sequence number."""
    from ..distributed.checkpoint import STAGING_SUFFIX, _commit
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    n = (int(step) if step is not None
         else max((_seq(d) for d in os.listdir(root)), default=0) + 1)
    final = os.path.join(root, f"tables_{n}")
    tmp = final + STAGING_SUFFIX
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    doc = {"format": 1, "created": time.time(), "tables": {}}
    for name, table in tables.items():
        fname = f"{name}.npz"
        state = table.state_dict()
        np.savez(os.path.join(tmp, fname), **state)
        doc["tables"][name] = {"file": fname,
                               "keys": sorted(state)}
    _commit(tmp, final, leaves={},
            extra_files={STATE_NAME: json.dumps(doc, indent=1)}, step=n)
    return final


def latest_valid_snapshot(root: str) -> Tuple[Optional[str], List[int]]:
    """(newest valid snapshot path or None, skipped step numbers).
    Torn/uncommitted dirs are skipped with a ``checkpoint_fallback``
    flight event — the checkpoint-reader discipline."""
    from ..distributed.checkpoint import verify_checkpoint
    from ..monitor.flight_recorder import safe_record_event
    skipped: List[int] = []
    if not os.path.isdir(root):
        return None, skipped
    seqs = sorted((_seq(d) for d in os.listdir(root)
                   if _SNAP_RE.match(d)), reverse=True)
    for n in seqs:
        path = os.path.join(root, f"tables_{n}")
        reason = verify_checkpoint(path)
        if reason is None:
            return path, skipped
        logger.warning("recsys table restore: skipping %s: %s",
                       path, reason)
        safe_record_event("checkpoint_fallback", step=n, reason=reason,
                          kind="recsys_tables")
        skipped.append(n)
    return None, skipped


def load_tables(root: str, tables: Dict[str, object]) -> Optional[str]:
    """Restore ``{name: table}`` from the newest valid snapshot under
    ``root`` (falling back past torn commits). Returns the snapshot
    path, or None when no valid snapshot exists (tables untouched)."""
    path, _skipped = latest_valid_snapshot(root)
    if path is None:
        return None
    with open(os.path.join(path, STATE_NAME)) as f:
        doc = json.load(f)
    for name, table in tables.items():
        entry = (doc.get("tables") or {}).get(name)
        if entry is None:
            raise KeyError(
                f"snapshot {path} has no table {name!r} "
                f"(has: {sorted(doc.get('tables') or {})})")
        with np.load(os.path.join(path, entry["file"])) as z:
            table.load_state_dict({k: z[k] for k in z.files})
    return path
