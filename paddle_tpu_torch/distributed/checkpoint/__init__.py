"""Atomically committed checkpoints on one process.

Counterpart of ``paddle_tpu/distributed/checkpoint/__init__.py``'s
commit protocol (CheckFreq-style, docs/FAULT_TOLERANCE.md): every save
writes into ``<path>.tmp``; the commit then writes the extra files and
an fsync'd manifest (per-leaf tree paths with shapes and dtypes, per-file
sizes, CRC32s under ``FLAGS_checkpoint_verify=full``, the step and a
flags fingerprint), fsyncs the directory and renames the staging
directory onto ``<path>`` (an existing checkpoint is parked under
``<path>.old`` for the two renames, then deleted). A process killed
mid-save leaves only a ``.tmp`` directory: :func:`latest_step` and
:func:`load` skip uncommitted or torn directories
(``FLAGS_checkpoint_verify``: off|manifest|full), recording a
``checkpoint_fallback`` flight event.

The manifest is the JAX package's: the same ``format``, keys and leaf
paths (``jax.tree_util.keystr`` strings such as ``['params']['w']`` or
``[0]``, built here without JAX), so either package's
``verify_checkpoint`` and ``read_manifest`` read the other's
directories. The leaf data is the port's own: one pickle of the state in
``framework/io.py``'s format (tensors as numpy arrays), ``STATE_NAME``.

Saves complete synchronously: ``save(..., asynchronous=True)`` returns
once the checkpoint is committed and :func:`wait` is a no-op. Async
saves, the ``CheckpointManager``, sharded state and resharding on load
(``load(target=...)``) are not ported.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...framework.io import load as _fload
from ...framework.io import save as _fsave

__all__ = ["save", "load", "wait", "save_train_step", "load_train_step",
           "latest_step", "checkpoint_steps", "verify_checkpoint",
           "read_manifest", "CheckpointError", "MANIFEST_NAME",
           "STAGING_SUFFIX", "STATE_NAME"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

MANIFEST_NAME = "paddle_tpu_manifest.json"
STAGING_SUFFIX = ".tmp"
REPLACED_SUFFIX = ".old"    # the replaced checkpoint, parked for the
                            # two renames of a same-path re-commit
#: the one data file of a port checkpoint: the state's leaves
STATE_NAME = "state.pdstate"

_NO_TARGET = ("load(target=...) restores into a declared layout "
              "(resharding), which this port does not have yet: it "
              "comes with async saves and the CheckpointManager")


class CheckpointError(RuntimeError):
    """A checkpoint save failed or a restore target failed verification."""


# ---------------------------------------------------------------------------
# Commit protocol
# ---------------------------------------------------------------------------

def _leaf_paths(tree, path: str = ""):
    """``(keystr, leaf)`` for every leaf, in ``jax.tree_util``'s order:
    dict keys sorted (an OrderedDict keeps its order), list and tuple
    items by index, namedtuple fields by name, None an empty node."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaf_paths(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, collections.OrderedDict)
                else sorted(tree))
        for k in keys:
            yield from _leaf_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(leaf.dtype)


def _leaf_manifest(state) -> Dict[str, dict]:
    """Tree path -> {shape, dtype} for every array leaf; scalars and
    strings are recorded by type."""
    leaves = {}
    for key, leaf in _leaf_paths(state):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            leaves[key] = {"shape": list(leaf.shape),
                           "dtype": _dtype_name(leaf)}
        else:
            leaves[key] = {"type": type(leaf).__name__}
    return leaves


def _flags_fingerprint() -> Dict[str, Any]:
    """Every flag's value at save time."""
    from ...core import flags as F
    out = {}
    for name in sorted(F._REGISTRY):
        v = F.get_flag(name)
        out[name] = v if isinstance(v, (bool, int, float, str,
                                        type(None))) else repr(v)
    return out


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _file_entries(root: str, checksum: bool) -> Dict[str, dict]:
    files = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            if dirpath == root and name == MANIFEST_NAME:
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            entry = {"size": os.path.getsize(full)}
            if checksum:
                entry["crc32"] = _crc32_file(full)
            files[rel] = entry
    return files


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass          # some filesystems refuse a directory fsync; the
    finally:          # rename still follows the manifest's file fsync
        os.close(fd)


def _record_event(event: str, **fields) -> None:
    from ...monitor.flight_recorder import safe_record_event
    safe_record_event(event, **fields)


def _commit(tmp: str, final: str, leaves: Dict[str, dict],
            extra_files: Optional[Dict[str, str]],
            step: Optional[int]) -> None:
    """Turn a finished staging directory into a committed checkpoint:
    extra files and manifest (fsync'd), then the rename. A crash at any
    point before the rename leaves only the ``.tmp`` directory, which
    every reader skips. Under an active step trace the commit is a
    ``checkpoint.commit`` span."""
    from ...monitor import trace as _trace
    with _trace.maybe_span("checkpoint.commit", step=step, path=final):
        _commit_impl(tmp, final, leaves, extra_files, step)


def _commit_impl(tmp: str, final: str, leaves: Dict[str, dict],
                 extra_files: Optional[Dict[str, str]],
                 step: Optional[int]) -> None:
    from ...core.flags import get_flag
    from ...testing import chaos

    for name, data in (extra_files or {}).items():
        p = os.path.join(tmp, name)
        with open(p, "w") as f:
            f.write(data)
        _fsync_file(p)
    # CRC32s re-read the whole staged tree: only under the level that
    # checks them ('manifest' checks sizes, 'full' skips absent CRCs)
    checksum = get_flag("checkpoint_verify") == "full"
    files = _file_entries(tmp, checksum=checksum)
    manifest = {"format": 1,
                "step": step,
                "created": time.time(),
                "flags": _flags_fingerprint(),
                "leaves": leaves,
                "files": files}
    mpath = os.path.join(tmp, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if chaos.active():
        # a torn write racing the commit: a data file loses its tail
        # after its size was recorded; verification must catch it
        if chaos.probe("ckpt.write.torn") and files:
            victim = max(files, key=lambda r: files[r]["size"])
            with open(os.path.join(tmp, victim), "r+b") as f:
                f.truncate(max(0, files[victim]["size"] // 2))
        if chaos.probe("ckpt.manifest.corrupt"):
            with open(mpath, "wb") as f:
                f.write(b"\x00garbage\x00" * 4)
    _fsync_dir(tmp)
    # replacing a committed checkpoint: park the old one (readers skip
    # the .old name), swap the new one in, then delete, so a crash
    # between the two renames leaves the old content on disk
    old = None
    if os.path.exists(final):
        old = final + REPLACED_SUFFIX
        if os.path.isdir(old):
            shutil.rmtree(old)
        elif os.path.exists(old):
            os.remove(old)
        os.rename(final, old)
    os.rename(tmp, final)
    _fsync_dir(os.path.dirname(final) or ".")
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    total = sum(e["size"] for e in files.values())
    _record_event("checkpoint_commit", path=final, step=step,
                  files=len(files), bytes=total)
    logger.info("checkpoint committed: %s (%d files, %d bytes)",
                final, len(files), total)


def verify_checkpoint(path: str, level: Optional[str] = None) \
        -> Optional[str]:
    """Validate a committed checkpoint directory: None when valid, else
    a human-readable reason. ``level`` defaults to
    ``FLAGS_checkpoint_verify`` (off|manifest|full)."""
    if level is None:
        from ...core.flags import get_flag
        level = get_flag("checkpoint_verify")
    if not os.path.isdir(path):
        return "missing (not a directory)"
    if level == "off":
        return None
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return "uncommitted (no manifest)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        return f"manifest unreadable ({type(e).__name__}: {e})"
    for rel, entry in files.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            return f"file missing: {rel}"
        size = os.path.getsize(full)
        if size != entry.get("size"):
            return (f"torn file: {rel} is {size} bytes, manifest says "
                    f"{entry.get('size')}")
        if level == "full" and "crc32" in entry:
            if _crc32_file(full) != entry["crc32"]:
                return f"checksum mismatch: {rel}"
    return None


def read_manifest(path: str) -> Optional[dict]:
    """The committed manifest of a checkpoint directory, or None."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def save(state: Dict[str, Any], path: str, asynchronous: bool = True,
         extra_files: Optional[Dict[str, str]] = None,
         step: Optional[int] = None) -> None:
    """Commit ``state`` (nested dicts, lists and tuples of tensors,
    arrays and scalars) as a checkpoint directory at ``path``.

    The save is synchronous whatever ``asynchronous`` says: the
    checkpoint is durable and committed when the call returns, and
    :func:`wait` has nothing to wait for. ``extra_files`` (name -> text)
    are committed inside the directory and covered by the manifest."""
    path = os.path.abspath(path)
    tmp = path + STAGING_SUFFIX
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)          # an orphan of a killed process
    os.makedirs(tmp)
    try:
        leaves = _leaf_manifest(state)
        state_path = os.path.join(tmp, STATE_NAME)
        _fsave(state, state_path)
        _fsync_file(state_path)
        _commit(tmp, path, leaves, extra_files, step)
    except Exception as e:
        shutil.rmtree(tmp, ignore_errors=True)
        raise CheckpointError(
            f"checkpoint save failed: {path}: {e!r} (staging dir "
            "removed; the previous committed checkpoint is intact)") from e


def wait() -> None:
    """A no-op: every :func:`save` commits before it returns."""


def _tensors(tree):
    """numpy arrays -> CPU tensors, through dicts, lists and tuples."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


def load(path: str, target=None):
    """Restore a checkpoint the port committed, its arrays as CPU
    tensors. Verification (``FLAGS_checkpoint_verify``) runs first: an
    uncommitted or torn directory raises :class:`CheckpointError`.
    ``target=`` raises ``NotImplementedError`` (no resharding here)."""
    if target is not None:
        raise NotImplementedError(_NO_TARGET)
    path = os.path.abspath(path)
    reason = verify_checkpoint(path)
    if reason is not None:
        raise CheckpointError(
            f"refusing to restore {path}: {reason}. Use latest_step() "
            "for the newest valid checkpoint, or "
            "FLAGS_checkpoint_verify=off for legacy dirs.")
    state_path = os.path.join(path, STATE_NAME)
    if not os.path.exists(state_path):
        raise CheckpointError(
            f"{path} holds no {STATE_NAME}: not a checkpoint this "
            "package wrote")
    return _tensors(_fload(state_path))


def checkpoint_steps(root: str) -> List[int]:
    """Committed ``step_<N>`` directory numbers under ``root``
    (ascending; staging ``.tmp`` directories excluded, validity not
    checked)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if not name.startswith("step_") or name.endswith(STAGING_SUFFIX):
            continue
        try:
            steps.append(int(name.split("_", 1)[1]))
        except ValueError:
            pass
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """Highest valid ``step_<N>`` checkpoint under ``root``. Uncommitted
    and verification-failing directories are skipped with a
    ``checkpoint_fallback`` flight event and a warning."""
    skipped = []
    for n in reversed(checkpoint_steps(root)):
        path = os.path.join(root, f"step_{n}")
        reason = verify_checkpoint(path)
        if reason is None:
            for bad_n, bad_reason in skipped:
                _record_event("checkpoint_fallback", step=bad_n,
                              reason=bad_reason, fallback_to=n)
            return n
        skipped.append((n, reason))
        logger.warning("skipping invalid checkpoint %s: %s", path, reason)
    for bad_n, bad_reason in skipped:
        _record_event("checkpoint_fallback", step=bad_n,
                      reason=bad_reason, fallback_to=None)
    return None


# -- TrainStep integration ---------------------------------------------------

def _listify(tree):
    """Tuples -> lists recursively, as the JAX package saves a train
    step (its restore target uses lists on both sides)."""
    if isinstance(tree, (tuple, list)):
        return [_listify(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _listify(v) for k, v in tree.items()}
    return tree


def _train_state(step) -> Dict[str, Any]:
    layer = step.layer
    params, frozen = {}, {}
    for k, p in layer.named_parameters():
        (params if p.requires_grad else frozen)[k] = p.detach()
    return {
        "params": params,
        "frozen": frozen,
        "buffers": {k: b.detach() for k, b in layer.named_buffers()},
        "opt_state": step.optimizer.state_dict(),
        "step_count": int(step.step_count),
        "rng_state": step.generator.get_state(),
        "lr": float(step.optimizer.get_lr()),
    }


def save_train_step(step, path: str, asynchronous: bool = True,
                    extra_files: Optional[Dict[str, str]] = None) -> None:
    """Commit a ``jit.TrainStep``'s whole training state: parameters
    (trainable and frozen), buffers, optimizer slots, step count, the
    step's dropout generator state and the learning rate. Synchronous
    (see :func:`save`)."""
    save(_listify(_train_state(step)), path, asynchronous=asynchronous,
         extra_files=extra_files, step=int(step.step_count))


@torch.no_grad()
def load_train_step(step, path: str):
    """Restore a checkpoint of :func:`save_train_step` into ``step``:
    every tensor is copied in place into the step's own parameters,
    buffers and slots, so the next steps are bit-equal to an
    uninterrupted run's. The names and shapes must match."""
    state = load(path)
    layer = step.layer
    params = dict(layer.named_parameters())
    saved = dict(state["params"], **state["frozen"])
    if sorted(saved) != sorted(params):
        raise CheckpointError(
            f"{path}: parameters {sorted(set(saved) ^ set(params))[:5]} "
            "are not in both the checkpoint and the step")
    buffers = dict(layer.named_buffers())
    if sorted(state["buffers"]) != sorted(buffers):
        raise CheckpointError(
            f"{path}: buffers "
            f"{sorted(set(state['buffers']) ^ set(buffers))[:5]} are not "
            "in both the checkpoint and the step")
    for name, t in list(saved.items()) + list(state["buffers"].items()):
        dst = params[name] if name in params else buffers[name]
        if tuple(dst.shape) != tuple(t.shape):
            raise CheckpointError(
                f"{path}: {name} is {tuple(t.shape)}, the step's "
                f"{tuple(dst.shape)}")
    for name, t in saved.items():
        params[name].copy_(t)
    for name, t in state["buffers"].items():
        buffers[name].copy_(t)
    step.optimizer.set_state_dict(state["opt_state"])
    step.optimizer.set_lr(float(state["lr"]))
    step.step_count = int(state["step_count"])
    step.generator.set_state(state["rng_state"])
    return step
