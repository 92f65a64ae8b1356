"""Industrial file datasets: InMemoryDataset and QueueDataset.

Counterpart of ``paddle_tpu/distributed/fleet/dataset.py`` (the
reference's ``fleet/dataset/dataset.py``: ``DatasetBase.init``,
``set_filelist``, ``InMemoryDataset`` with ``load_into_memory``,
``local_shuffle``, ``global_shuffle``, ``release_memory`` and
``get_memory_data_size``, over the C++ MultiSlotDataFeed). As in the
JAX package the data-feed pipeline runs on the host: each file is
streamed through the user's ``pipe_command`` (a shell pipeline, as in
the reference) or read directly, parsed line by line by ``parse_fn``
(default: the MultiSlot text format ``slot_size v v ... slot_size
...``), and batched into numpy arrays that a ``TrainStep`` takes.
``global_shuffle`` keeps the samples a trainer owns by a stable hash,
the reference's cross-trainer exchange when every trainer loads the
same files; the memory accounting counts samples.
"""

from __future__ import annotations

import random
import subprocess
from typing import Callable, List, Sequence

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset"]


def _stable_mix(seed: int, i: int) -> int:
    """Interpreter-independent sample->trainer hash (python's builtin
    hash() is implementation-defined, so trainers on different runtimes
    could partition inconsistently)."""
    x = (seed * 0x9E3779B97F4A7C15 + i * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 29)


def _parse_multislot(line: str):
    """The reference MultiSlotDataFeed text format: for each slot,
    `<n> v1 ... vn` (floats); returns a list of np arrays, one per slot."""
    parts = line.split()
    out = []
    i = 0
    while i < len(parts):
        n = int(parts[i])
        vals = parts[i + 1:i + 1 + n]
        if len(vals) != n:
            raise ValueError(
                f"corrupt MultiSlot line: slot declares {n} values but "
                f"{len(vals)} remain: {line[:120]!r}")
        out.append(np.asarray([float(v) for v in vals], np.float32))
        i += 1 + n
    return out


class DatasetBase:
    """The reference's dataset.py ``DatasetBase``."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.pipe_command = None
        self.use_var: Sequence = ()
        self.filelist: List[str] = []
        self.parse_fn: Callable = _parse_multislot
        self.drop_last = False

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command=None, input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", parse_fn=None, drop_last=False,
             shared_filelist=False, **kwargs):
        # shared_filelist=True declares that EVERY trainer loads the same
        # files, which is what makes the hash partition in global_shuffle
        # a correct exchange substitute
        self.batch_size = batch_size
        self.thread_num = thread_num
        self.use_var = use_var or ()
        self.pipe_command = pipe_command
        if parse_fn is not None:
            self.parse_fn = parse_fn
        self.drop_last = drop_last
        self.shared_filelist = shared_filelist

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def _read_file(self, path: str):
        if self.pipe_command:
            stdin_f = open(path, "rb")
            proc = subprocess.Popen(self.pipe_command, shell=True,
                                    stdin=stdin_f,
                                    stdout=subprocess.PIPE, text=True)
            drained = False
            try:
                for line in proc.stdout:
                    line = line.strip()
                    if line:
                        yield self.parse_fn(line)
                drained = True
            finally:
                proc.stdout.close()
                if drained:
                    # only a fully-drained pipe reports failures; an early
                    # consumer break (generator close) just kills the child
                    if proc.wait() != 0:
                        raise RuntimeError(
                            f"pipe_command {self.pipe_command!r} failed "
                            f"on {path}")
                else:
                    proc.kill()
                    proc.wait()
                stdin_f.close()
        else:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield self.parse_fn(line)

    def _iter_samples(self):
        for path in self.filelist:
            yield from self._read_file(path)

    @staticmethod
    def _collate(buf):
        n_slots = len(buf[0])
        return [np.stack([s[i] for s in buf]) for i in range(n_slots)]

    def _batches(self, samples):
        buf = []
        for s in samples:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)


class QueueDataset(DatasetBase):
    """Streaming dataset: files are parsed as iteration proceeds (the
    reference's ``QueueDataset`` over the C++ queue feed)."""

    def __iter__(self):
        return self._batches(self._iter_samples())


class InMemoryDataset(DatasetBase):
    """Load-then-train dataset with shuffles (the reference's
    ``InMemoryDataset``)."""

    def __init__(self):
        super().__init__()
        self._memory: List = []
        self._seed = 0

    def load_into_memory(self, is_shuffle=False):
        self._memory = list(self._iter_samples())
        if is_shuffle:
            self.local_shuffle()

    def preload_into_memory(self, thread_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self):
        rng = random.Random(self._seed)
        self._seed += 1
        rng.shuffle(self._memory)

    def global_shuffle(self, fleet=None, thread_num=12):
        """Cross-trainer exchange: keep the samples this trainer owns by
        hash (the reference exchanges them over gloo; every trainer
        loading the same files gives each the same ownership)."""
        from ..env import get_rank, get_world_size
        n = get_world_size()
        me = get_rank()
        if n > 1:
            if not getattr(self, "shared_filelist", False):
                raise RuntimeError(
                    "global_shuffle with world_size > 1 requires "
                    "init(shared_filelist=True) and the SAME full "
                    "filelist on every trainer (each keeps its hash "
                    "shard). With per-trainer split filelists the data "
                    "is already partitioned — use local_shuffle().")
            self._memory = [s for i, s in enumerate(self._memory)
                            if _stable_mix(self._seed, i) % n == me]
        self.local_shuffle()

    def release_memory(self):
        self._memory = []

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._memory)

    def get_shuffle_data_size(self, fleet=None) -> int:
        return len(self._memory)

    def __iter__(self):
        return self._batches(iter(self._memory))
