"""Multi-tenant LoRA adapter pools for the serving engine.

Counterpart of ``paddle_tpu/serving/lora.py``. Adapters are rank-r
deltas on the fused QKV projection; the bgmv kernel
(``ops/kernels/bgmv.py``) applies a different adapter to each batch row
of one prefill or decode dispatch, so requests for different fine-tunes
share a batch.

:class:`LoRAManager` owns the device pools, stacked per layer:
``a [L, A, r, E]`` and ``b [L, A, r, 3*H*D]``, row ``A`` the adapter.
Row 0 is the zero adapter: base-model requests ride it with a delta of
exactly 0.0. Host-side it keeps a name -> row map and per-adapter slot
references: admission acquires, slot release drops, and
:meth:`LoRAManager.unload_adapter` refuses while a slot holds one.

A load writes its row of the pools in place, between steps, on the
engine's stream, so no dispatch ever sees half an adapter; nothing keeps
a host copy that could go stale. Loading from a checkpoint directory
(``path=``, :func:`save_adapter_checkpoint`) waits for the port of
``distributed/`` checkpointing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

__all__ = ["LoRAManager", "save_adapter_checkpoint"]

_CKPT_LATER = ("adapter checkpoints go through distributed/ checkpointing, "
               "which a later slice of the port brings; pass weights=")


def save_adapter_checkpoint(path: str, lora_a, lora_b) -> None:
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_CKPT_LATER)


class LoRAManager:
    """Device adapter pools + host name/refcount bookkeeping.

    ``max_adapters`` is the number of loadable adapters; the pools hold
    ``max_adapters + 1`` float32 rows (row 0 the zero adapter).
    ``out_features`` is the fused-QKV width ``3 * H * D``."""

    def __init__(self, num_layers: int, hidden_size: int,
                 out_features: int, *, max_adapters: int, rank: int,
                 device: DeviceLike = None):
        if max_adapters < 1:
            raise ValueError("max_adapters must be >= 1")
        if rank < 1:
            raise ValueError("rank must be >= 1")
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.hidden_size = int(hidden_size)
        self.out_features = int(out_features)
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        rows = self.max_adapters + 1
        self.a = torch.zeros((num_layers, rows, rank, hidden_size),
                             device=self.device)
        self.b = torch.zeros((num_layers, rows, rank, out_features),
                             device=self.device)
        self._rows: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        self._free: List[int] = list(range(1, rows))
        #: cumulative loads
        self.swaps = 0

    # -- introspection -------------------------------------------------------
    @property
    def num_loaded(self) -> int:
        return len(self._rows)

    def loaded(self) -> List[str]:
        return sorted(self._rows)

    def row(self, name: str) -> Optional[int]:
        """Pool row serving ``name``, or None when not loaded."""
        return self._rows.get(name)

    def refcount(self, name: str) -> int:
        return self._refs.get(name, 0)

    # -- lifecycle -----------------------------------------------------------
    def load_adapter(self, name: str, weights=None,
                     path: Optional[str] = None) -> int:
        """Load an adapter and return its pool row.

        ``weights``: ``(a [L, r, E], b [L, r, O])`` arrays or tensors.
        Shapes are checked before the pools change, so a bad adapter
        leaves the manager as it was. Loading a name that is already
        loaded returns its row and changes nothing: replacing an adapter
        takes an explicit unload, because in-flight requests may use the
        row."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        existing = self._rows.get(name)
        if existing is not None:
            return existing
        if (weights is None) == (path is None):
            raise ValueError("pass exactly one of weights= or path=")
        if path is not None:
            raise NotImplementedError(_CKPT_LATER)
        a, b = (torch.as_tensor(w) for w in weights)
        L, r = self.num_layers, self.rank
        want_a = (L, r, self.hidden_size)
        want_b = (L, r, self.out_features)
        if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
            raise ValueError(
                f"adapter {name!r}: weights are a{tuple(a.shape)} / "
                f"b{tuple(b.shape)}, this manager serves a{want_a} / "
                f"b{want_b}")
        if not self._free:
            raise RuntimeError(
                f"adapter pool full ({self.max_adapters} rows); unload "
                "an unreferenced adapter first")
        row = self._free.pop(0)
        self.a[:, row].copy_(a)
        self.b[:, row].copy_(b)
        self._rows[name] = row
        self._refs[name] = 0
        self.swaps += 1
        return row

    def unload_adapter(self, name: str) -> None:
        """Refcounted unload: only an adapter no slot references may
        leave. Its row is zeroed, so a stale id can only ever select the
        zero delta, and returns to the free list."""
        row = self._rows.get(name)
        if row is None:
            raise KeyError(f"adapter {name!r} is not loaded")
        refs = self._refs.get(name, 0)
        if refs > 0:
            raise RuntimeError(
                f"adapter {name!r} still referenced by {refs} slot(s); "
                "unload only when no slot references the adapter")
        del self._rows[name]
        self._refs.pop(name, None)
        self.a[:, row].zero_()
        self.b[:, row].zero_()
        self._free.append(row)

    # -- slot references -----------------------------------------------------
    def acquire(self, name: str) -> int:
        """Admission-time reference: a slot now decodes against
        ``name``. Returns the pool row."""
        row = self._rows.get(name)
        if row is None:
            raise KeyError(f"adapter {name!r} is not loaded")
        self._refs[name] = self._refs.get(name, 0) + 1
        return row

    def release(self, name: str) -> None:
        """Drop a slot's reference (finish, failure or preemption)."""
        refs = self._refs.get(name, 0)
        if refs <= 0:
            raise RuntimeError(
                f"release of adapter {name!r} without a live reference")
        self._refs[name] = refs - 1

    def rows_for(self, names: Sequence[Optional[str]]) -> torch.Tensor:
        """Adapter rows ``[len(names)]`` int32 on the pools' device for
        a dispatch: ``None`` (a base-model request, an empty slot or a
        padded prefill row) is the zero adapter, row 0."""
        rows = np.array([0 if n is None else self._rows[n] for n in names],
                        np.int32)
        return torch.from_numpy(rows).to(self.device)
