"""Checkpoint save/load: ``paddle.save`` / ``paddle.load``.

Counterpart of ``paddle_tpu/framework/io.py``: a pickle of nested dicts,
lists and tuples in which every ``torch.Tensor`` becomes a numpy array,
so the JAX package loads what the port writes and the other way round.
``encryption_key`` writes the authenticated blob of :mod:`.crypto`
(``PTPUENC1 | nonce | ct | tag``), the same bytes the JAX package reads.

numpy has no bfloat16 of its own, and the port does not import
``ml_dtypes``. So a bf16 tensor is written as its float32 widening,
which loses nothing (every bf16 value is a float32 value), and a caller
that loads it into a bf16 tensor gets the same bits back. The other
way, an array whose ``dtype.name`` is ``"bfloat16"`` (one the JAX
package wrote) loads as a torch bf16 tensor with the same bits, through
a ``uint16`` view; unpickling such a file needs ``ml_dtypes`` installed,
as it is wherever JAX is. Every other array loads as numpy, as in the
JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core.tensor import Tensor
from .crypto import _MAGIC, decrypt_bytes, encrypt_bytes

__all__ = ["save", "load", "to_numpy"]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bf16 widened to float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.clone().numpy()


def _to_saveable(obj):
    if type(obj) is Tensor:
        obj = obj._data
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj):
    if isinstance(obj, np.ndarray) and obj.dtype.name == "bfloat16":
        return torch.from_numpy(obj.view(np.uint16).copy()).view(
            torch.bfloat16)
    if isinstance(obj, dict):
        return {k: _from_saved(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4,
         encryption_key: bytes = None, **configs):
    """Pickle ``obj`` to ``path`` with tensors as numpy arrays;
    ``encryption_key`` writes an encrypted blob."""
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    saveable = _to_saveable(obj)
    if encryption_key is not None:
        payload = encrypt_bytes(pickle.dumps(saveable, protocol=protocol),
                                encryption_key)
        with open(path, "wb") as f:
            f.write(payload)
        return
    with open(path, "wb") as f:
        pickle.dump(saveable, f, protocol=protocol)


def load(path: str, encryption_key: bytes = None, **configs) -> Any:
    """Unpickle what :func:`save` (of either package) wrote. Unpickling
    can run code: load only files this program or a trusted one
    wrote."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            f.seek(0)
            return _from_saved(pickle.load(f))
        if encryption_key is None:
            raise ValueError(
                f"{path!r} is an encrypted model file — pass "
                "encryption_key= to paddle.load")
        payload = head + f.read()
    return _from_saved(pickle.loads(decrypt_bytes(payload,
                                                  encryption_key)))
