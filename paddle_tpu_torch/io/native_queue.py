"""ctypes binding for the native blocking queue (C++ reader core).

reference parity: the Python face of LoDTensorBlockingQueue
(reference: operators/reader/blocking_queue.h + pybind bindings in
pybind/reader_py.cc). Here the binding is ctypes over a C ABI — no
pybind11 in the image — and the payloads are arbitrary byte buffers
(pickled batches / raw numpy), with the copy into C-heap memory freeing
the Python producer immediately.

Counterpart of ``paddle_tpu/io/native_queue.py`` over a copy of its
C++ source (``_native/blocking_queue.cpp``). The shared library is
compiled with g++ at first use into ``paddle_tpu_torch/_build/`` (beside
the kernels' libraries, never next to the source), under a name that
embeds the source hash, so a changed source is never served by a stale
binary. ``native_available()`` reports whether the toolchain produced a
usable library; the DataLoader falls back to a ``multiprocessing``
queue when it did not (host code, not a device path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "_native",
                    "blocking_queue.cpp")


_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")


def _lib_path() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return None          # source not shipped: fall back gracefully
    return os.path.join(_BUILD_DIR, f"libblocking_queue-{digest}.so")


_lib_handle = None
_build_failed = False      # failures are cached: one compile attempt/process
_build_lock = threading.Lock()


class QueueClosed(Exception):
    pass


class QueueKilled(Exception):
    pass


def _build() -> Optional[ctypes.CDLL]:
    global _lib_handle, _build_failed
    with _build_lock:
        if _lib_handle is not None:
            return _lib_handle
        if _build_failed:
            return None
        lib_file = _lib_path()
        if lib_file is None:
            _build_failed = True
            return None
        if not os.path.exists(lib_file):
            # build to a private temp path and atomically publish, so a
            # concurrent/interrupted build can never leave a half-written
            # .so at the trusted final name
            tmp = f"{lib_file}.{os.getpid()}.tmp"
            try:
                os.makedirs(_BUILD_DIR, exist_ok=True)
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-pthread", _SRC,
                     "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, lib_file)
            except (subprocess.SubprocessError, FileNotFoundError, OSError):
                _build_failed = True
                return None
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            # sweep the libraries of older source revisions
            import glob
            for old in glob.glob(os.path.join(
                    os.path.dirname(lib_file), "libblocking_queue*.so")):
                if old != lib_file:
                    try:
                        os.remove(old)
                    except OSError:
                        pass
        try:
            lib = ctypes.CDLL(lib_file)
        except OSError:
            _build_failed = True
            return None
        lib.pq_create.restype = ctypes.c_void_p
        lib.pq_create.argtypes = [ctypes.c_size_t]
        lib.pq_destroy.argtypes = [ctypes.c_void_p]
        lib.pq_send.restype = ctypes.c_int
        lib.pq_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
        lib.pq_receive.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.pq_receive.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t),
                                   ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.pq_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.pq_close.argtypes = [ctypes.c_void_p]
        lib.pq_kill.argtypes = [ctypes.c_void_p]
        lib.pq_size.restype = ctypes.c_size_t
        lib.pq_size.argtypes = [ctypes.c_void_p]
        lib.pq_closed.restype = ctypes.c_int
        lib.pq_closed.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


def native_available() -> bool:
    return _build() is not None


class NativeBlockingQueue:
    """Bounded blocking byte queue over the C++ core."""

    def __init__(self, capacity: int = 8):
        lib = _build()
        if lib is None:
            raise RuntimeError("native blocking queue unavailable "
                               "(g++ build failed)")
        self._lib = lib
        self._q = lib.pq_create(capacity)
        if not self._q:
            raise ValueError("capacity must be > 0")

    def put(self, data: bytes) -> None:
        if not self._lib.pq_send(self._q, data, len(data)):
            raise QueueClosed("queue closed")

    def get(self, timeout: Optional[float] = None) -> bytes:
        size = ctypes.c_size_t()
        status = ctypes.c_int()
        ms = -1 if timeout is None else int(timeout * 1000)
        buf = self._lib.pq_receive(self._q, ctypes.byref(size), ms,
                                   ctypes.byref(status))
        st = status.value
        if st == 1:
            try:
                return ctypes.string_at(buf, size.value)
            finally:
                self._lib.pq_free(buf)
        if st == 0:
            raise QueueClosed("queue closed and drained")
        if st == -1:
            raise TimeoutError("queue get timed out")
        raise QueueKilled("queue killed")

    def close(self) -> None:
        if self._q:
            self._lib.pq_close(self._q)

    def kill(self) -> None:
        # a no-op once destroyed: a finalizer may call it after __del__
        if self._q:
            self._lib.pq_kill(self._q)

    def qsize(self) -> int:
        return self._lib.pq_size(self._q)

    def __del__(self):
        try:
            if getattr(self, "_q", None):
                self._lib.pq_destroy(self._q)
                self._q = None
        except Exception:
            pass
