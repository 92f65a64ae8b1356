"""Parameter-server process model: C++ server binary + python client.

reference parity: the brpc PS stack —
PSServer/PSClient (reference: paddle/fluid/distributed/service/
brpc_ps_server.h, brpc_ps_client.h), the async Communicator
(service/communicator.cc: grad queues merged and flushed by a background
thread), table sharding across servers, and the fleet PS role protocol
(python/paddle/distributed/fleet/base/role_maker.py: TRAINING_ROLE /
PADDLE_PSERVERS_IP_PORT_LIST env contract).

TPU-native redesign: the server is a standalone C++ process
(`_native/ps_server.cpp`, compiled on first use with g++) speaking a lean
length-prefixed TCP protocol; rows move as raw f32 buffers straight into
numpy, which jitted steps consume as ordinary host inputs. Keys are
sharded CLIENT-side across servers with the same splitmix64 hash the
server uses for lock striping, so adding servers rebalances without any
coordinator. The async communicator merges duplicate-key gradients
host-side before sending — the reference's merge_sparse_grad semantics.

Counterpart of ``paddle_tpu/distributed/ps/service.py``, a copy (numpy
and sockets) over its own copy of the server source
(``_native/ps_server.cpp``), so the two packages' servers speak the same
protocol and lazily initialise the same rows. The binary is built with
``g++ -O2 -std=c++17 -pthread`` at first use into
``paddle_tpu_torch/_build/`` (never beside the source), named by the
source's hash. A failed build raises with the compiler's message; there
is no fallback to the in-process table.
"""

from __future__ import annotations

import hashlib
import os
import queue
import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "_native", "ps_server.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "_build")

# protocol op codes (keep in sync with ps_server.cpp)
_PING, _CREATE, _PULL_DENSE, _PUSH_DENSE, _PUSH_DENSE_GRAD = 0, 1, 2, 3, 4
_PULL_SPARSE, _PUSH_SPARSE_GRAD, _PUSH_SPARSE = 5, 6, 7
_SAVE, _LOAD, _STATS, _STOP, _KIND, _ADD_SPARSE = 8, 9, 10, 11, 12, 13

_OPT_KINDS = {"sgd": 0, "adagrad": 1, "adam": 2}


_build_lock = threading.Lock()


def _binary_path() -> str:
    """Compile the server binary on first use, named by source hash;
    raises ``RuntimeError`` with the compiler's output if it fails."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(_BUILD_DIR, f"ps_server-{digest}")
    with _build_lock:
        if os.path.exists(out):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        try:
            subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", _SRC,
                            "-o", tmp], check=True, capture_output=True,
                           text=True, timeout=300)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"building the PS server from {_SRC} failed:\n"
                f"{e.stderr}") from e
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(
                f"building the PS server from {_SRC} failed: {e}") from e
        os.replace(tmp, out)
        return out


def native_available() -> bool:
    """Whether the server binary builds here (False where ``g++`` fails
    or is missing)."""
    try:
        _binary_path()
    except RuntimeError:
        return False
    return True


def _mix64(x):
    """splitmix64 over uint64 numpy arrays (wrapping arithmetic) — must
    match ps_server.cpp mix64 for deterministic placement. Vectorized:
    the owner computation sits on the hot pull/push path of every step."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class PSServerHandle:
    """A running parameter-server process on this host.

    `host` is the BIND address: the loopback default keeps single-host
    tests private; multi-host fleets pass "0.0.0.0" (run_server does)
    so trainers reach the server over the pod's DCN."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        binary = _binary_path()
        self._proc = subprocess.Popen([binary, str(port), host],
                                      stdout=subprocess.PIPE, text=True)
        line = self._proc.stdout.readline()
        if not line.startswith("PS_SERVER_READY"):
            raise RuntimeError(f"ps_server failed to start: {line!r}")
        self.port = int(line.split()[1])
        client_host = "127.0.0.1" if host == "0.0.0.0" else host
        self.endpoint = f"{client_host}:{self.port}"

    def wait(self, timeout: Optional[float] = None) -> int:
        return self._proc.wait(timeout=timeout)

    def kill(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()


class _Conn:
    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.lock = threading.Lock()

    def request(self, op: int, table: int, payload: bytes = b"") -> bytes:
        with self.lock:
            self.sock.sendall(struct.pack("<BIQ", op, table, len(payload))
                              + payload)
            hdr = self._recv(9)
            status, n = struct.unpack("<BQ", hdr)
            body = self._recv(n) if n else b""
        if status != 0:
            raise RuntimeError(f"ps server error: {body.decode()!r}")
        return body

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("ps server closed connection")
            buf += chunk
        return bytes(buf)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class PSClient:
    """Client over one or more PS endpoints with client-side key sharding.

    Dense table `t` lives wholly on server `t % nservers`; sparse rows
    are scattered `mix64(key) % nservers` (splitmix64 avoids hot servers
    for clustered id ranges, e.g. frequency-sorted vocabularies).
    """

    def __init__(self, endpoints: Sequence[str]):
        if not endpoints:
            raise ValueError("need at least one PS endpoint")
        self._conns = [_Conn(ep) for ep in endpoints]
        self.n = len(self._conns)
        self._kinds: Dict[int, str] = {}

    # -- admin ----------------------------------------------------------
    def ping(self) -> None:
        for c in self._conns:
            c.request(_PING, 0)

    def create_table(self, table_id: int, *, kind: str, dim: int,
                     rows: int = 0, optimizer: str = "adagrad",
                     lr: float = 0.05, seed: int = 0,
                     init_scale: float = 0.01) -> None:
        payload = struct.pack("<BBfQQIf", 0 if kind == "dense" else 1,
                              _OPT_KINDS[optimizer], lr, dim, rows, seed,
                              init_scale)
        self._kinds[table_id] = kind
        if kind == "dense":
            self._conns[table_id % self.n].request(_CREATE, table_id,
                                                   payload)
        else:
            for c in self._conns:       # sparse: every server holds a shard
                c.request(_CREATE, table_id, payload)

    def stop_servers(self) -> None:
        for c in self._conns:
            try:
                c.request(_STOP, 0)
            except (ConnectionError, RuntimeError, OSError):
                pass
            c.close()

    # -- dense ----------------------------------------------------------
    def pull_dense(self, table_id: int, rows: int, dim: int) -> np.ndarray:
        body = self._conns[table_id % self.n].request(_PULL_DENSE, table_id)
        return np.frombuffer(body, np.float32).reshape(rows, dim).copy()

    def push_dense(self, table_id: int, values: np.ndarray,
                   grad: bool = False) -> None:
        op = _PUSH_DENSE_GRAD if grad else _PUSH_DENSE
        self._conns[table_id % self.n].request(
            op, table_id, np.ascontiguousarray(values, np.float32).tobytes())

    # -- sparse ---------------------------------------------------------
    def _split(self, keys: np.ndarray) -> List[np.ndarray]:
        if self.n == 1:
            return [np.arange(len(keys))]
        owner = _mix64(keys) % np.uint64(self.n)
        return [np.nonzero(owner == s)[0] for s in range(self.n)]

    def pull_sparse(self, table_id: int, keys: np.ndarray,
                    dim: int) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.empty((len(keys), dim), np.float32)
        for s, idx in enumerate(self._split(keys)):
            if len(idx) == 0:
                continue
            sub = keys[idx]
            payload = struct.pack("<Q", len(sub)) + sub.tobytes()
            body = self._conns[s].request(_PULL_SPARSE, table_id, payload)
            out[idx] = np.frombuffer(body, np.float32).reshape(len(sub), dim)
        return out

    def push_sparse(self, table_id: int, keys: np.ndarray,
                    values: np.ndarray, grad: bool = True) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)
        if grad and len(keys) > 1:
            # merge duplicate keys BEFORE the optimizer apply (dense
            # embedding-gradient semantics; the server applies each
            # request row sequentially, which differs for adagrad/adam)
            uniq, inv = np.unique(keys, return_inverse=True)
            if len(uniq) != len(keys):
                acc = np.zeros((len(uniq), values.shape[1]), np.float32)
                np.add.at(acc, inv, values)
                keys, values = uniq, acc
        self._send_rows(_PUSH_SPARSE_GRAD if grad else _PUSH_SPARSE,
                        table_id, keys, values)

    def add_sparse(self, table_id: int, keys: np.ndarray,
                   deltas: np.ndarray) -> None:
        """w[key] += delta — geo-SGD aggregation (reference: geo tables,
        communicator.cc GeoCommunicator send path). No client-side dedup:
        the server's += already sums duplicate keys."""
        self._send_rows(_ADD_SPARSE, table_id,
                        np.ascontiguousarray(keys, np.uint64),
                        np.ascontiguousarray(deltas, np.float32))

    def _send_rows(self, op: int, table_id: int, keys: np.ndarray,
                   values: np.ndarray) -> None:
        for s, idx in enumerate(self._split(keys)):
            if len(idx) == 0:
                continue
            sub, vals = keys[idx], values[idx]
            payload = struct.pack("<Q", len(sub)) + sub.tobytes() \
                + vals.tobytes()
            self._conns[s].request(op, table_id, payload)

    # -- checkpoint / stats ---------------------------------------------
    def table_kind(self, table_id: int) -> str:
        """'dense' | 'sparse' | 'absent' — queried from the servers when
        this client did not create the table itself (e.g. a separate
        checkpointing process)."""
        kind = self._kinds.get(table_id)
        if kind is None:
            owner = self._conns[table_id % self.n]
            k = owner.request(_KIND, table_id)[0]
            kind = {0: "dense", 1: "sparse", 2: "absent"}[k]
            if kind != "absent":
                self._kinds[table_id] = kind
        return kind

    def _table_conns(self, table_id: int):
        """(shard, conn) pairs owning this table: the single owner for a
        dense table, every server for a sparse one."""
        if self.table_kind(table_id) == "dense":
            s = table_id % self.n
            return [(s, self._conns[s])]
        return list(enumerate(self._conns))

    def save(self, table_id: int, dirname: str) -> None:
        os.makedirs(dirname, exist_ok=True)
        for s, c in self._table_conns(table_id):
            path = os.path.join(dirname, f"table{table_id}.shard{s}")
            c.request(_SAVE, table_id, path.encode())

    def load(self, table_id: int, dirname: str) -> None:
        for s, c in self._table_conns(table_id):
            path = os.path.join(dirname, f"table{table_id}.shard{s}")
            if os.path.exists(path):
                c.request(_LOAD, table_id, path.encode())

    def num_rows(self, table_id: int) -> int:
        return sum(struct.unpack("<Q", c.request(_STATS, table_id))[0]
                   for c in self._conns)

    def close(self) -> None:
        for c in self._conns:
            c.close()


class AsyncCommunicator:
    """Background gradient sender (reference: service/communicator.cc).

    Worker threads enqueue sparse gradients; one sender thread merges
    duplicate keys (gradient sum — the reference's merge_sparse_grad) and
    pushes batches, overlapping PS traffic with the next device step.
    `send_every` bounds staleness; `flush()` drains synchronously.
    """

    def __init__(self, client: PSClient, send_every: float = 0.01):
        self._client = client
        self._q: "queue.Queue" = queue.Queue()
        self._send_every = send_every
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def push_sparse_grad(self, table_id: int, keys: np.ndarray,
                         grads: np.ndarray) -> None:
        if self._err is not None:
            raise RuntimeError("communicator failed") from self._err
        self._idle.clear()
        self._q.put((table_id, np.asarray(keys), np.asarray(grads)))

    def _drain_batch(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Concatenate everything queued per table; the duplicate-key SUM
        happens vectorized inside PSClient.push_sparse."""
        pending: Dict[int, list] = {}
        while True:
            try:
                table, keys, grads = self._q.get_nowait()
            except queue.Empty:
                break
            pending.setdefault(table, []).append((keys, grads))
        return {t: (np.concatenate([k for k, _ in items]),
                    np.concatenate([g for _, g in items]))
                for t, items in pending.items()}

    def _run(self) -> None:
        try:
            while not self._stop.is_set() or not self._q.empty():
                merged = self._drain_batch()
                if not merged:
                    self._idle.set()
                    time.sleep(self._send_every)
                    continue
                for table, (keys, grads) in merged.items():
                    self._client.push_sparse(
                        table, keys.astype(np.uint64),
                        grads.astype(np.float32), grad=True)
                if self._q.empty():
                    self._idle.set()
        except BaseException as e:          # surfaced on next push/flush
            self._err = e
            self._idle.set()

    def flush(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not (self._q.empty() and self._idle.is_set()):
            if self._err is not None:
                raise RuntimeError("communicator failed") from self._err
            if time.monotonic() > deadline:
                raise TimeoutError("communicator flush timed out")
            time.sleep(0.002)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)
        if self._err is not None:
            raise RuntimeError("communicator failed") from self._err


class GeoCommunicator:
    """Geo-SGD training mode (reference: communicator.cc GeoCommunicator,
    distributed/table geo tables): each worker trains a LOCAL copy of the
    touched rows and periodically pushes parameter DELTAS, which servers
    sum — communication-efficient async training for sparse models.

    Usage: `pull(keys)` serves rows from a local trainable cache,
    `update(keys, rows)` writes trained rows back, and `maybe_sync()`
    (call once per step) pushes `local - base` deltas and refreshes the
    base every `trigger_steps`.
    """

    def __init__(self, client: PSClient, table_id: int, dim: int,
                 trigger_steps: int = 10):
        self._client = client
        self._table = table_id
        self._dim = dim
        self._trigger = trigger_steps
        self._step = 0
        self._local: Dict[int, np.ndarray] = {}   # key -> current row
        self._base: Dict[int, np.ndarray] = {}    # key -> row at last sync
        self._dirty: set = set()                  # keys updated since sync

    def pull(self, keys: np.ndarray) -> np.ndarray:
        """Rows for `keys`, served from the local cache when present."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        if len(keys) == 0:
            return np.zeros((0, self._dim), np.float32)
        missing = [int(k) for k in keys if int(k) not in self._local]
        if missing:
            fetched = self._client.pull_sparse(
                self._table, np.asarray(missing, np.uint64), self._dim)
            for k, row in zip(missing, fetched):
                self._local[k] = row.copy()
                self._base[k] = row.copy()
        return np.stack([self._local[int(k)] for k in keys])

    def update(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Write locally-trained rows back into the cache."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        for k, row in zip(keys, np.asarray(rows, np.float32)):
            self._local[int(k)] = row.copy()
            self._dirty.add(int(k))

    def maybe_sync(self) -> bool:
        """Every trigger_steps: push accumulated deltas, refresh bases
        from the server (absorbing other workers' deltas)."""
        self._step += 1
        if self._step % self._trigger:
            return False
        if self._dirty:
            # only the keys touched since the last sync travel (the
            # reference GeoCommunicator keeps the same delta-id sets);
            # untouched cache entries are dropped so the local cache does
            # not grow with the worker's lifetime key set
            keys = np.fromiter(self._dirty, np.uint64, len(self._dirty))
            deltas = np.stack([self._local[int(k)] - self._base[int(k)]
                               for k in keys])
            self._client.add_sparse(self._table, keys, deltas)
            fresh = self._client.pull_sparse(self._table, keys, self._dim)
            clean = set(self._local) - self._dirty
            for k, row in zip(keys, fresh):
                self._local[int(k)] = row.copy()
                self._base[int(k)] = row.copy()
            for k in clean:
                self._local.pop(k, None)
                self._base.pop(k, None)
            self._dirty.clear()
        return True


# ---------------------------------------------------------------------------
# fleet PS-mode role protocol (reference: fleet/base/role_maker.py env vars)
# ---------------------------------------------------------------------------


def role_from_env() -> str:
    """'TRAINER' | 'PSERVER' from TRAINING_ROLE (reference contract)."""
    return os.environ.get("TRAINING_ROLE", "TRAINER").upper()


def server_endpoints_from_env() -> List[str]:
    eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
    return [e for e in eps.split(",") if e]


def run_server(port: Optional[int] = None) -> PSServerHandle:
    """Start this host's PS process (reference: fleet.run_server).
    Binds all interfaces so trainers on other hosts can connect."""
    if port is None:
        ep = os.environ.get("PADDLE_PORT")
        port = int(ep) if ep else 0
    return PSServerHandle(port=port, host="0.0.0.0")
