"""Atomically committed, sharded, asynchronous checkpoints.

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
directories. The leaf data is the port's own: pickles in
``framework/io.py``'s format (tensors as numpy arrays).

- **Single process**: one file, ``STATE_NAME``, holds the whole state.
- **Sharded** (a state whose array leaves include :class:`Shard`, as
  :func:`save_train_step` builds on a mesh; every rank of the world
  calls :func:`save` together): each rank writes the blocks it owns to
  ``shard_rank<r>.pdstate`` -- a block is written by the one rank at
  coordinate 0 of every mesh axis the leaf is not sharded over, never
  by its replicas -- and rank 0 writes the rest of the tree to
  ``STATE_NAME``. The manifest records each sharded leaf's global shape
  and its spec (the mesh axes of each dimension). Rank 0 commits once
  every rank's files are down (the ranks agree over the world group).
- **Asynchronous** (``asynchronous=True``): the call returns once the
  state is snapshotted to host memory; a background thread writes the
  files, and the commit runs at :func:`wait` or at the next save, where
  a failure of the writer (on any rank) re-raises as
  :class:`CheckpointError` and the staging directory goes. This is
  the default of every save, as in the JAX package;
  ``asynchronous=False`` commits before it returns.

:func:`load` assembles the whole state from the blocks, and
``load(target=...)`` cuts each leaf into the layout the target declares
(:class:`Layout`: a mesh and a ``{dim: axes}`` block, a ZeRO dimension),
which may be another factorisation or one process;
:func:`load_train_step` hands the whole state to the step's own
``set_state_dict``, which cuts it into the step's layout, whatever
layout saved it. The ``CheckpointManager`` and
``PreemptionSignal`` (``manager.py``) drive interval saves, SIGTERM and
resume.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...framework.io import load as _fload
from ...framework.io import save as _fsave

__all__ = ["save", "load", "wait", "save_train_step", "load_train_step",
           "latest_step", "checkpoint_steps", "verify_checkpoint",
           "read_manifest", "CheckpointError", "Checkpointer", "Shard",
           "Layout", "CheckpointManager", "PreemptionSignal",
           "MANAGER_STATE_NAME", "MANIFEST_NAME", "STAGING_SUFFIX",
           "STATE_NAME"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

MANIFEST_NAME = "paddle_tpu_manifest.json"
STAGING_SUFFIX = ".tmp"
REPLACED_SUFFIX = ".old"    # the replaced checkpoint, parked for the
                            # two renames of a same-path re-commit
#: the data file of a port checkpoint: the state's leaves (in a
#: sharded checkpoint the tree without its sharded leaves)
STATE_NAME = "state.pdstate"
#: a rank's blocks of the sharded leaves
SHARD_NAME = "shard_rank{}.pdstate"


class CheckpointError(RuntimeError):
    """A checkpoint save failed or a restore target failed verification."""


class Shard:
    """A rank's block of a sharded array leaf: ``block`` (this rank's
    tensor), the leaf's global ``shape``, the block's ``starts`` (its
    offset in each dimension), ``spec`` (per dimension the list of mesh
    axes it is split over, or None) and ``owner`` (this rank writes it:
    the other ranks hold replicas of the same block)."""

    def __init__(self, block: torch.Tensor, shape, starts, spec,
                 owner: bool):
        self.block = block
        self.shape = tuple(int(d) for d in shape)
        self.starts = tuple(int(s) for s in starts)
        self.spec = spec
        self.owner = bool(owner)


class Layout:
    """Where a leaf goes on :func:`load`: this rank's block of the whole
    by ``layout`` (``{dim: axes}`` over ``mesh``, as
    ``spmd.shard_tensor`` cuts it), then narrowed over ``zero`` (a ZeRO
    ``(dim, group)``), as ``dtype`` (None: the saved one)."""

    def __init__(self, layout=None, mesh=None, zero=None, dtype=None):
        self.layout, self.mesh, self.zero, self.dtype = \
            dict(layout or {}), mesh, zero, dtype

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        from ..spmd import cut_block
        t = cut_block(full, self.layout, self.mesh, self.zero)
        return t if self.dtype is None else t.to(self.dtype)


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
    """Tree path -> {shape, dtype} for every array leaf (a :class:`Shard`
    with its global shape and its spec); scalars and strings are
    recorded by type."""
    leaves = {}
    for key, leaf in _leaf_paths(state):
        if isinstance(leaf, Shard):
            leaves[key] = {"shape": list(leaf.shape),
                           "dtype": _dtype_name(leaf.block),
                           "spec": leaf.spec}
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
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

def _host(t):
    """A host copy of a tensor (the async snapshot); anything else as
    it is."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return t


def _split(state):
    """``(tree, blocks)``: the tree with every :class:`Shard` replaced
    by a reference to its path (tensors copied to the host), and this
    rank's owned blocks ``{path: (starts, host tensor)}``."""
    blocks = {}

    def walk(tree, path):
        if isinstance(tree, Shard):
            if tree.owner:
                blocks[path] = (tree.starts, _host(tree.block))
            return _ShardRef(path)
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(getattr(tree, n), f"{path}.{n}")
                                for n in tree._fields))
        if isinstance(tree, dict):
            return type(tree)((k, walk(v, f"{path}[{k!r}]"))
                              for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}[{i}]")
                              for i, v in enumerate(tree))
        return _host(tree)
    return walk(state, ""), blocks


class _ShardRef:
    """The place of a sharded leaf in the saved tree: its path."""

    def __init__(self, path: str):
        self.path = path

    def __reduce__(self):
        return (_ShardRef, (self.path,))


def _has_shards(tree) -> bool:
    return any(isinstance(leaf, Shard) for _, leaf in _leaf_paths(tree))


def _world():
    """``(rank, nranks)`` of the world a sharded save spans."""
    from .. import env
    return env.get_rank(), env.get_world_size()


def _agree(ok: bool) -> bool:
    """True when every rank of the world says ``ok`` (a sharded save's
    vote before and after the commit)."""
    from ..collective import all_gather_object
    votes: List = []
    all_gather_object(votes, bool(ok))
    return all(votes)


def _write(tmp: str, tree, blocks, rank: int, sharded: bool) -> None:
    """This rank's files of a save into ``tmp``, fsync'd."""
    if rank == 0:
        p = os.path.join(tmp, STATE_NAME)
        _fsave(tree, p)
        _fsync_file(p)
    if sharded:
        p = os.path.join(tmp, SHARD_NAME.format(rank))
        _fsave(blocks, p)
        _fsync_file(p)


class _Pending:
    """An async save between its snapshot and its commit."""

    def __init__(self, tmp, final, leaves, extra_files, step, sharded):
        self.tmp, self.final, self.leaves = tmp, final, leaves
        self.extra_files, self.step, self.sharded = extra_files, step, \
            sharded
        self.thread = None
        self.error: Optional[BaseException] = None


class Checkpointer:
    """The process's checkpoint writer: at most one async save awaits
    its commit (a new save or :meth:`wait` finalizes it first, re-raising
    its failure)."""

    _instance: Optional["Checkpointer"] = None

    def __init__(self):
        self._pending: Optional[_Pending] = None

    @classmethod
    def instance(cls) -> "Checkpointer":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def save(self, path: str, state, asynchronous: bool = True,
             extra_files: Optional[Dict[str, str]] = None,
             step: Optional[int] = None) -> None:
        if self._pending is not None:
            self.wait()
        path = os.path.abspath(path)
        tmp = path + STAGING_SUFFIX
        sharded = _has_shards(state)
        rank = _world()[0] if sharded else 0
        leaves = _leaf_manifest(state)
        tree, blocks = _split(state)
        ok, err = True, None
        if rank == 0:
            try:
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp)      # an orphan of a killed process
                os.makedirs(tmp)
            except OSError as e:
                ok, err = False, e
        if sharded and not _agree(ok):
            raise CheckpointError(
                f"checkpoint save failed: {path}: rank 0 could not stage "
                f"{tmp} ({err!r})")
        if not ok:
            raise CheckpointError(f"checkpoint save failed: {path}: "
                                  f"{err!r}") from err
        pend = _Pending(tmp, path, leaves, extra_files, step, sharded)
        if not asynchronous:
            try:
                _write(tmp, tree, blocks, rank, sharded)
            except Exception as e:
                pend.error = e
            self._finish(pend)
            return

        def writer():
            try:
                _write(tmp, tree, blocks, rank, sharded)
            except BaseException as e:      # re-raised at wait()
                pend.error = e
        pend.thread = threading.Thread(target=writer, daemon=True,
                                       name="ptpu-ckpt-writer")
        pend.thread.start()
        self._pending = pend

    def pending_ready(self) -> bool:
        """True when the pending async save has finished writing, so
        :meth:`wait` commits without blocking on the files."""
        p = self._pending
        return p is not None and not p.thread.is_alive()

    def pending_path(self) -> Optional[str]:
        """The staging directory of the pending async save, or None."""
        return None if self._pending is None else self._pending.tmp

    def wait(self) -> None:
        """Block until the pending async save is written and committed;
        re-raises a failure of its writer (on any rank) or its commit."""
        pend, self._pending = self._pending, None
        if pend is None:
            return
        pend.thread.join()
        self._finish(pend)

    def _finish(self, pend: _Pending) -> None:
        """Commit a written save (rank 0, once every rank's files are
        down), or remove it and raise."""
        rank = _world()[0] if pend.sharded else 0
        ok = pend.error is None
        if pend.sharded:
            ok = _agree(ok)
        if ok and rank == 0:
            try:
                _commit(pend.tmp, pend.final, pend.leaves, pend.extra_files,
                        pend.step)
            except Exception as e:
                pend.error, ok = e, False
        if pend.sharded:
            ok = _agree(ok)
        if ok:
            return
        if rank == 0:
            shutil.rmtree(pend.tmp, ignore_errors=True)
        why = repr(pend.error) if pend.error is not None \
            else "failed on another rank"
        raise CheckpointError(
            f"checkpoint save failed: {pend.final}: {why} (staging dir "
            "removed; the previous committed checkpoint is intact)"
        ) from pend.error


def save(state: Dict[str, Any], path: str, asynchronous: bool = True,
         extra_files: Optional[Dict[str, str]] = None,
         step: Optional[int] = None) -> None:
    """Commit ``state`` (nested dicts, lists and tuples of tensors,
    arrays, :class:`Shard` blocks and scalars) as a checkpoint directory
    at ``path``. By default (``asynchronous=True``) the call returns once
    the state is on the host and commits at :func:`wait` or the next
    save; ``asynchronous=False`` commits before it returns. A state with
    :class:`Shard` leaves is a sharded save: every rank calls it.
    ``extra_files`` (name -> text) are committed inside the directory
    and covered by the manifest."""
    Checkpointer.instance().save(path, state, asynchronous,
                                 extra_files=extra_files, step=step)


def wait() -> None:
    """Block until the pending async save is durable and committed;
    re-raises its failure."""
    Checkpointer.instance().wait()


def _tensors(tree):
    """numpy arrays -> CPU tensors, through dicts, lists and tuples."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


_NP_DTYPES = {"bfloat16": torch.bfloat16}


def _assemble(path: str, tree, leaves: Dict[str, dict]):
    """The whole state of a sharded checkpoint: every rank's blocks put
    in place of the tree's references."""
    full = {}
    for name in sorted(os.listdir(path)):
        if not (name.startswith("shard_rank") and name.endswith(".pdstate")):
            continue
        for key, (starts, block) in _fload(os.path.join(path, name)).items():
            block = torch.as_tensor(block)
            if key not in full:
                meta = leaves[key]
                full[key] = torch.empty(meta["shape"], dtype=block.dtype)
            dst = full[key]
            for d, (s, n) in enumerate(zip(starts, block.shape)):
                dst = dst.narrow(d, s, n)
            dst.copy_(block)

    def fill(t):
        if isinstance(t, _ShardRef):
            if t.path not in full:
                raise CheckpointError(f"{path}: no rank wrote {t.path}")
            return full[t.path]
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return t
    return fill(tree)


def _retarget(state, target):
    """Each leaf of ``state`` in the form the matching leaf of
    ``target`` declares: a :class:`Layout` cuts it, a tensor gives its
    dtype; anything else (or no match) keeps the saved leaf."""
    if isinstance(target, Layout) and isinstance(state, torch.Tensor):
        return target.cut(state)
    if isinstance(target, torch.Tensor) and isinstance(state, torch.Tensor):
        return state.to(target.dtype)
    if isinstance(state, dict) and isinstance(target, dict):
        return {k: _retarget(v, target.get(k)) for k, v in state.items()}
    if isinstance(state, (list, tuple)) and isinstance(target,
                                                        (list, tuple)):
        return type(state)(_retarget(v, t) for v, t in zip(state, target))
    return state


def load(path: str, target=None):
    """Restore a checkpoint the port committed, its arrays as CPU
    tensors (a sharded one assembled whole). Verification
    (``FLAGS_checkpoint_verify``) runs first: an uncommitted or torn
    directory raises :class:`CheckpointError`. ``target`` (a tree like
    the state's, :class:`Layout` or tensor leaves) reshards each leaf
    into the layout it declares."""
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
    state = _fload(state_path)
    manifest = read_manifest(path) or {}
    leaves = manifest.get("leaves", {})
    if any("spec" in v for v in leaves.values()):
        state = _assemble(path, state, leaves)
    state = _tensors(state)
    return state if target is None else _retarget(state, target)
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


def _leaf_layouts(step):
    """name -> ``(param, zero)`` for every parameter and optimizer slot
    of a step on a mesh (``zero``: the slot's ZeRO ``(dim, group)``)."""
    out = {k: (p, None) for k, p in step.layer.named_parameters()}
    out.update(step._slot_layouts())
    return out


def _shard(step, t: torch.Tensor, p, zero):
    """The :class:`Shard` of ``t``, a block of ``p``'s full shape under
    its mesh layout (and ``zero``), on ``step``'s mesh."""
    from ..spmd import mesh_slice
    mesh = step.mesh
    full = tuple(p._full_shape)
    spec, starts, used = [None] * len(full), [0] * len(full), set()
    for d, axes in p._dist_layout.items():
        spec[d] = list(axes)
        starts[d] = mesh_slice(mesh, axes, full[d])[0]
        used.update(axes)
    if zero is not None:
        d, group = zero
        spec[d] = [step.zero_axis]
        starts[d] = group.rank * (full[d] // group.nranks)
        used.add(step.zero_axis)
    owner = all(mesh.axis_rank(a) == 0 for a in mesh.axis_names
                if a not in used)
    return Shard(t, full, starts, spec, owner)


def _train_state(step) -> Dict[str, Any]:
    layer = step.layer
    params, frozen = {}, {}
    for k, p in layer.named_parameters():
        (params if p.requires_grad else frozen)[k] = p.detach()
    opt = step.optimizer.state_dict()
    if step.mesh is not None:
        lay = _leaf_layouts(step)

        def sharded(d):
            return {k: _shard(step, v, *lay[k]) if k in lay and
                    isinstance(v, torch.Tensor) and v.dim() else v
                    for k, v in d.items()}
        params, frozen, opt = sharded(params), sharded(frozen), sharded(opt)
    return {
        "params": params,
        "frozen": frozen,
        "buffers": {k: b.detach() for k, b in layer.named_buffers()},
        "opt_state": opt,
        "step_count": int(step.step_count),
        "rng_state": step.generator.get_state(),
        "lr": float(step.optimizer.get_lr()),
    }


def save_train_step(step, path: str, asynchronous: bool = True,
                    extra_files: Optional[Dict[str, str]] = None) -> None:
    """Commit a ``jit.TrainStep``'s whole training state: parameters
    (trainable and frozen), buffers, optimizer slots, step count, the
    step's dropout generator state and the learning rate. On a mesh a
    sharded save (every rank calls it; each writes the blocks it owns).
    Asynchronous unless ``asynchronous=False`` (see :func:`save`)."""
    save(_listify(_train_state(step)), path, asynchronous=asynchronous,
         extra_files=extra_files, step=int(step.step_count))


@torch.no_grad()
def load_train_step(step, path: str):
    """Restore a checkpoint of :func:`save_train_step` into ``step``,
    whatever layout saved it (another factorisation of the mesh, or one
    process): the whole state goes to the step's own
    ``set_state_dict``, which cuts it into the step's layout and copies
    it in place, so a same-layout resume continues bit-equal to an
    uninterrupted run. The names must match."""
    state = load(path)
    layer = step.layer
    want = layer.state_dict()
    saved = dict(state["params"], **state["frozen"])
    saved.update({k: b for k, b in state["buffers"].items() if k in want})
    if sorted(saved) != sorted(want):
        raise CheckpointError(
            f"{path}: parameters or buffers "
            f"{sorted(set(saved) ^ set(want))[:5]} are not in both the "
            "checkpoint and the step")
    full = {k: tuple(getattr(p, "_full_shape", p.shape))
            for k, p in layer.named_parameters()}
    for name, t in saved.items():
        shape = full.get(name, tuple(want[name].shape))
        if tuple(t.shape) != tuple(shape):
            raise CheckpointError(
                f"{path}: {name} is {tuple(t.shape)}, the step's {shape}")
    step.set_state_dict({"params": saved, "opt_state": state["opt_state"],
                         "lr": state["lr"],
                         "step_count": state["step_count"],
                         "rng_state": state["rng_state"]})
    return step


from .manager import (MANAGER_STATE_NAME, CheckpointManager,  # noqa: E402
                      PreemptionSignal)
