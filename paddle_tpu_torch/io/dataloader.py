"""DataLoader.

Counterpart of ``paddle_tpu/io/dataloader.py`` (reference:
python/paddle/fluid/reader.py:146 DataLoader,
dataloader/dataloader_iter.py, operators/reader/buffered_reader.cc),
with its signature.

Worker processes produce collated numpy batches. With
``use_shared_memory`` (the default) each worker pickles a batch once
into a pipe, a drain thread forwards the raw frames into the C++
bounded blocking queue of :mod:`.native_queue`, and the consumer
unpickles once; where g++ cannot build that library the workers put
their batches on a ``multiprocessing`` queue instead. Batches come back
in order, and a worker's exception is raised in the caller. Workers
start by ``spawn``, not the JAX package's ``fork``: the consumer
process holds CUDA's and PyTorch's threads, and a forked child inherits
their locks in whatever state they were. So the dataset, ``collate_fn``
and ``worker_init_fn`` must pickle (defined at a module's top level).

The device prefetcher replaces the JAX package's ``device_put`` double
buffer: it keeps ``prefetch_factor`` batches in flight, each copied from
page-locked host memory with ``non_blocking=True`` on a side CUDA
stream, and the consumer's stream waits on that copy's event before the
batch is used. On the CPU there is no pinning and no stream. Batches
are torch tensors (``return_list`` either way: the port has no
``Tensor`` wrapper). ``places`` is the card unless ``"cpu"`` is passed.

The consumer's wait for a batch is the goodput ledger's ``data_wait``
bucket (``monitor.goodput.measure``, one flag read with
``FLAGS_train_goodput`` off), as in the JAX package.
"""

from __future__ import annotations

import functools
import itertools
import multiprocessing as mp
import pickle
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..monitor import goodput as _goodput
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "WorkerInfo", "default_collate_fn",
           "get_worker_info"]


def default_collate_fn(batch):
    """Stack samples into batched arrays (structure-preserving): numpy
    samples into numpy, torch samples into torch."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return np.asarray(batch)


class WorkerInfo:
    """Identifies the current DataLoader worker inside dataset code
    (e.g. to shard an IterableDataset across workers)."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """The WorkerInfo of the calling worker process, or None in the main
    process."""
    return _worker_info


def _worker_loop(dataset, index_queue, sink, collate_fn, worker_init_fn,
                 worker_id, num_workers, pipe):
    """One worker: index batches in, ``(batch_id, batch, error)`` out,
    as raw pickled frames on a pipe (``pipe``) or on a queue."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_id, indices = item
        try:
            payload = (batch_id, collate_fn([dataset[i] for i in indices]),
                       None)
        except Exception as e:  # handed to the consumer, which raises it
            payload = (batch_id, None, e)
        if not pipe:
            sink.put(payload)
            continue
        try:
            sink.send_bytes(pickle.dumps(payload, protocol=4))
        except (BrokenPipeError, OSError):
            break
    if pipe:
        sink.close()


def _drain_pipes(native_q, conns, stop_event):
    """Forward raw pickled frames from the worker pipes into the C++
    queue; holds no reference to the iterator, and closes the queue on
    exit so a blocked consumer raises instead of hanging."""
    from multiprocessing.connection import wait as conn_wait

    from .native_queue import QueueClosed
    try:
        live = list(conns)
        while live and not stop_event.is_set():
            for conn in conn_wait(live, timeout=0.2):
                try:
                    frame = conn.recv_bytes()
                except (EOFError, OSError):
                    live.remove(conn)
                    continue
                try:
                    native_q.put(frame)      # bounded: blocks in C
                except QueueClosed:          # killed by the consumer
                    return
    finally:
        native_q.close()


def _reap(workers, drain_thread, conns, queues):
    """Join the stopped workers (terminating one that does not exit
    within a second) and the drain thread, then close the pipes.
    ``queues`` stay referenced until then: a worker still starting up
    unpickles their locks."""
    for w in workers:
        w.join(timeout=1.0)
        if w.is_alive():
            w.terminate()
            w.join()
    if drain_thread is not None:
        drain_thread.join()
    for c in conns:
        c.close()


class _MultiprocessIter:
    def __init__(self, loader):
        self.loader = loader
        ctx = mp.get_context("spawn")
        self.index_queue = ctx.Queue()
        self.out_queue = None
        self.workers = []
        self._native_q = None
        self._drain_thread = None
        self._stop_event = threading.Event()
        self._worker_conns = []

        if loader.use_shared_memory:
            from .native_queue import NativeBlockingQueue, native_available
            if native_available():
                self._native_q = NativeBlockingQueue(
                    max(2, loader.prefetch_factor * loader.num_workers))
        if self._native_q is None:
            self.out_queue = ctx.Queue()

        for wid in range(loader.num_workers):
            if self._native_q is not None:
                r, sink = ctx.Pipe(duplex=False)
                self._worker_conns.append(r)
            else:
                sink = self.out_queue
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self.index_queue, sink,
                      loader.collate_fn, loader.worker_init_fn, wid,
                      loader.num_workers, self._native_q is not None),
                daemon=True)
            w.start()
            self.workers.append(w)
            if self._native_q is not None:
                sink.close()                 # the parent keeps the read end

        if self._native_q is not None:
            self._drain_thread = threading.Thread(
                target=_drain_pipes,
                args=(self._native_q, list(self._worker_conns),
                      self._stop_event),
                daemon=True)
            self._drain_thread.start()

        self.batch_iter = iter(loader.batch_sampler)
        self.send_id = 0
        self.recv_id = 0
        self.reorder = {}
        self.exhausted = False
        for _ in range(loader.num_workers * 2):
            self._send_next()

    def _recv(self):
        if self._native_q is not None:
            from .native_queue import QueueClosed, QueueKilled
            try:
                return pickle.loads(self._native_q.get())
            except (QueueClosed, QueueKilled):
                raise RuntimeError("DataLoader pipeline shut down")
        return self.out_queue.get()

    def _send_next(self):
        if self.exhausted:
            return
        try:
            indices = next(self.batch_iter)
        except StopIteration:
            self.exhausted = True
            return
        self.index_queue.put((self.send_id, indices))
        self.send_id += 1

    def __next__(self):
        if self.recv_id >= self.send_id and self.exhausted:
            self._shutdown()
            raise StopIteration
        while self.recv_id not in self.reorder:
            batch_id, data, err = self._recv()
            if err is not None:
                self._shutdown()
                raise err
            self.reorder[batch_id] = data
        data = self.reorder.pop(self.recv_id)
        self.recv_id += 1
        self._send_next()
        return data

    def _shutdown(self):
        """Stop the workers and the drain thread. The prefetcher reads
        ahead, so the sampler runs out while the consumer still has
        batches to take: the workers' exit (an interpreter teardown
        each, hundreds of milliseconds) is waited for on a thread of
        its own, not on the consumer's."""
        self._stop_event.set()
        for _ in self.workers:
            self.index_queue.put(None)
        if self._native_q is not None:
            self._native_q.kill()
        if not (self.workers or self._drain_thread or self._worker_conns):
            return
        reap = functools.partial(_reap, self.workers, self._drain_thread,
                                 self._worker_conns,
                                 (self.index_queue, self.out_queue))
        self.workers, self._drain_thread, self._worker_conns = [], None, []
        try:
            threading.Thread(target=reap, daemon=True).start()
        except RuntimeError:                 # the interpreter is exiting
            reap()

    def __del__(self):
        self._shutdown()


class _SingleProcessIter:
    def __init__(self, loader):
        self.loader = loader
        self.batch_iter = iter(loader.batch_sampler)

    def __next__(self):
        indices = next(self.batch_iter)
        samples = [self.loader.dataset[i] for i in indices]
        return self.loader.collate_fn(samples)


class _IterableDatasetIter:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.dataset)

    def __next__(self):
        batch = list(itertools.islice(self.it, self.loader.batch_size))
        if not batch or (self.loader.drop_last and
                         len(batch) < self.loader.batch_size):
            raise StopIteration
        return self.loader.collate_fn(batch)


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.require(x, requirements=["C", "W"]))


def _map(fn, batch):
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return fn(batch)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return batch


class _DevicePrefetcher:
    """Keeps ``depth`` batches in flight to ``device``: on the card each
    one is copied from pinned host memory on a side stream, and
    ``__next__`` makes the consumer's stream wait on its event."""

    def __init__(self, inner, device: torch.device, depth=2):
        self.inner = inner
        self.device = device
        self.depth = max(1, depth)
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.buffer = []
        self._fill()

    def _launch(self, batch):
        if self.stream is None:
            return _map(_host_tensor, batch), None
        pinned = _map(lambda x: _host_tensor(x).pin_memory(), batch)
        with torch.cuda.stream(self.stream):
            dev = _map(lambda t: t.to(self.device, non_blocking=True),
                       pinned)
            event = self.stream.record_event()
        return dev, (event, pinned)

    def _fill(self):
        while len(self.buffer) < self.depth:
            try:
                batch = next(self.inner)
            except StopIteration:
                break
            self.buffer.append(self._launch(batch))

    def __next__(self):
        # the consumer-facing wait: the goodput ledger's data_wait
        with _goodput.measure("data_wait"):
            if not self.buffer:
                raise StopIteration
            out, pending = self.buffer.pop(0)
            if pending is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(pending[0])
                # memory allocated on the side stream, used on the
                # consumer's: the allocator must not reuse it before then
                _map(lambda t: t.record_stream(consumer), out)
            self._fill()
            return out

    def __iter__(self):
        return self


class _PlainIter:
    """``use_buffer_reader=False``: each batch moved to the device when
    it is asked for."""

    def __init__(self, inner, device):
        self.inner = inner
        self.device = device

    def __next__(self):
        with _goodput.measure("data_wait"):
            return _map(lambda x: _host_tensor(x).to(self.device),
                        next(self.inner))

    def __iter__(self):
        return self


class DataLoader:
    """reference: fluid/reader.py DataLoader:146."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.worker_init_fn = worker_init_fn
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = prefetch_factor
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._is_iterable_ds = isinstance(dataset, IterableDataset)
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.places = resolve_device(places)

        if not self._is_iterable_ds:
            if batch_sampler is not None:
                self.batch_sampler = batch_sampler
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)

    def __iter__(self):
        if self._is_iterable_ds:
            inner = _IterableDatasetIter(self)
        elif self.num_workers > 0:
            inner = _MultiprocessIter(self)
        else:
            inner = _SingleProcessIter(self)
        if self.use_buffer_reader:
            return _DevicePrefetcher(inner, self.places,
                                     depth=self.prefetch_factor)
        return _PlainIter(inner, self.places)

    def __len__(self):
        if self._is_iterable_ds:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)
