"""Graph table + service: the PS stack's graph-learning tail.

Counterpart of ``paddle_tpu/distributed/ps/graph.py``, a copy (numpy and
sockets, same wire format).

reference parity: paddle/fluid/distributed/table/common_graph_table.h:1
(GraphTable: typed nodes/edges, neighbor sampling, node features) and
service/graph_brpc_server.cc (the brpc service exposing it to trainers
for GNN pipelines).

TPU-native redesign: graph sampling is HOST work feeding device batches
— the table lives in host RAM as CSR adjacency per edge type (numpy,
vectorized sampling) and serves either in-process (the usual pod
layout: every worker's host holds a shard) or over the same
length-prefixed TCP framing the C++ parameter server uses
(`GraphService`/`GraphClient`, python — the hot path of a GNN step is
the sampler, which is numpy-vectorized; the dense/sparse parameter
traffic stays on the C++ server).

Trust model / wire safety: the TCP protocol is the same typed
struct+numpy framing family as ps/service.py — an op name plus
primitively-typed fields (ints/floats/bools/strings) and dtyped numpy
buffers. NO pickle and no other code-bearing encoding crosses the
socket in either direction, the server dispatches only the explicit
method allowlist below (never getattr on attacker-chosen names), and
ndarray decoding is restricted to a numeric-dtype allowlist, so a
malicious peer can at worst feed wrong graph data. The protocol still
has no authentication or encryption: bind to loopback (the default) or
deploy on a trusted pod network, exactly like the C++ parameter server.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GraphTable", "GraphService", "GraphClient"]


class GraphTable:
    """Typed graph in host memory (reference: common_graph_table.h).

    Edges are grouped by ``edge_type``; ``build()`` freezes them into CSR
    for vectorized neighbor sampling. Node features are named dense
    arrays keyed by node id.
    """

    def __init__(self, seed: int = 0):
        self._pending: Dict[str, List] = {}
        self._csr: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._nodes: Dict[str, np.ndarray] = {}      # node_type -> ids
        self._feats: Dict[str, Dict[str, np.ndarray]] = {}  # name->{id->row}
        self._feat_store: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._rng = np.random.default_rng(seed)

    # -- construction ------------------------------------------------------
    def add_graph_node(self, node_type: str, ids) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        prev = self._nodes.get(node_type)
        self._nodes[node_type] = ids if prev is None else \
            np.unique(np.concatenate([prev, ids]))

    def add_edges(self, edge_type: str, src, dst) -> None:
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.asarray(dst, np.int64).reshape(-1)
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        if edge_type in self._csr and edge_type not in self._pending:
            # CSR exists with no pending source chunks — this edge type
            # came from load(), which clears _pending. Decompose the CSR
            # back into a pending chunk BEFORE invalidating, or the next
            # build() would rebuild from the new edges alone and silently
            # drop everything previously loaded.
            uniq, indptr, csr_dst = self._csr[edge_type]
            csr_src = np.repeat(uniq, np.diff(indptr))
            self._pending[edge_type] = [(csr_src, csr_dst)]
        self._pending.setdefault(edge_type, []).append((src, dst))
        self._csr.pop(edge_type, None)       # invalidate built form

    def set_node_feat(self, feat_name: str, ids, rows) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        rows = np.asarray(rows, np.float32)
        rows = rows.reshape(len(ids), -1)
        old_ids, old_rows = self._feat_store.get(
            feat_name, (np.empty(0, np.int64),
                        np.empty((0, rows.shape[1]), np.float32)))
        keep = ~np.isin(old_ids, ids)
        merged_ids = np.concatenate([old_ids[keep], ids])
        merged_rows = np.concatenate([old_rows[keep], rows])
        order = np.argsort(merged_ids)      # get_node_feat searchsorts
        self._feat_store[feat_name] = (merged_ids[order],
                                       merged_rows[order])

    def build(self) -> None:
        """Freeze pending edges into CSR (reference: build_sampler)."""
        for et, chunks in self._pending.items():
            if et in self._csr:
                continue
            src = np.concatenate([s for s, _ in chunks])
            dst = np.concatenate([d for _, d in chunks])
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
            uniq, starts = np.unique(src, return_index=True)
            indptr = np.append(starts, len(src))
            self._csr[et] = (uniq, indptr, dst)

    # -- queries -----------------------------------------------------------
    def _adj(self, edge_type: str):
        if edge_type not in self._csr:
            self.build()
        if edge_type not in self._csr:
            raise KeyError(f"no edges of type {edge_type!r}")
        return self._csr[edge_type]

    def sample_neighbors(self, edge_type: str, ids, sample_size: int,
                         replace: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Up to ``sample_size`` neighbors per id (reference:
        graph_brpc_server sample_neighbors). Returns (flat_neighbors,
        counts) — counts[i] neighbors for ids[i], concatenated."""
        uniq, indptr, dst = self._adj(edge_type)
        ids = np.asarray(ids, np.int64).reshape(-1)
        pos = np.searchsorted(uniq, ids)
        found = (pos < len(uniq)) & (uniq[np.minimum(pos, len(uniq) - 1)]
                                     == ids)
        out: List[np.ndarray] = []
        counts = np.zeros(len(ids), np.int64)
        for i, (p, ok) in enumerate(zip(pos, found)):
            if not ok:
                continue
            nbrs = dst[indptr[p]:indptr[p + 1]]
            if len(nbrs) > sample_size and not replace:
                nbrs = self._rng.choice(nbrs, sample_size, replace=False)
            elif replace:
                nbrs = self._rng.choice(nbrs, sample_size, replace=True)
            counts[i] = len(nbrs)
            out.append(nbrs)
        flat = np.concatenate(out) if out else np.empty(0, np.int64)
        return flat, counts

    def random_sample_nodes(self, node_type: str,
                            sample_size: int) -> np.ndarray:
        ids = self._nodes.get(node_type)
        if ids is None or not len(ids):
            return np.empty(0, np.int64)
        k = min(sample_size, len(ids))
        return self._rng.choice(ids, k, replace=False)

    def get_node_feat(self, feat_name: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        fid, rows = self._feat_store.get(
            feat_name, (np.empty(0, np.int64),
                        np.empty((0, 0), np.float32)))
        dim = rows.shape[1] if rows.size else 0
        out = np.zeros((len(ids), dim), np.float32)
        pos = np.searchsorted(fid, ids)
        ok = (pos < len(fid)) & (fid[np.minimum(pos, len(fid) - 1)] == ids)
        out[ok] = rows[pos[ok]]
        return out

    def degree(self, edge_type: str, ids) -> np.ndarray:
        uniq, indptr, _ = self._adj(edge_type)
        ids = np.asarray(ids, np.int64).reshape(-1)
        pos = np.searchsorted(uniq, ids)
        ok = (pos < len(uniq)) & (uniq[np.minimum(pos, len(uniq) - 1)]
                                  == ids)
        deg = np.zeros(len(ids), np.int64)
        deg[ok] = indptr[pos[ok] + 1] - indptr[pos[ok]]
        return deg

    # -- checkpoint --------------------------------------------------------
    def save(self, dirname: str) -> None:
        os.makedirs(dirname, exist_ok=True)
        self.build()
        state = {"csr": self._csr, "nodes": self._nodes,
                 "feats": self._feat_store}
        with open(os.path.join(dirname, "graph_table.pkl"), "wb") as f:
            pickle.dump(state, f)

    def load(self, dirname: str) -> None:
        with open(os.path.join(dirname, "graph_table.pkl"), "rb") as f:
            state = pickle.load(f)
        self._csr = state["csr"]
        self._nodes = state["nodes"]
        self._feat_store = state["feats"]
        self._pending = {}


# ---------------------------------------------------------------------------
# TCP service (reference: graph_brpc_server.cc) — same length-prefixed
# framing family as the C++ parameter server. Messages are typed fields
# (see the module docstring's trust model): no pickle on the wire.
# ---------------------------------------------------------------------------

# field type tags
_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_NDARRAY, _T_LIST = range(7)

# only plain numeric buffers may decode into arrays: object/void/structured
# dtypes never cross the wire
_DTYPE_ALLOW = frozenset("biufc")


def _pack_value(v) -> bytes:
    if v is None:
        return struct.pack("<B", _T_NONE)
    if isinstance(v, (bool, np.bool_)):
        return struct.pack("<BB", _T_BOOL, int(v))
    if isinstance(v, (int, np.integer)):
        return struct.pack("<Bq", _T_INT, int(v))
    if isinstance(v, (float, np.floating)):
        return struct.pack("<Bd", _T_FLOAT, float(v))
    if isinstance(v, str):
        raw = v.encode("utf-8")
        return struct.pack("<BI", _T_STR, len(raw)) + raw
    if isinstance(v, (list, tuple)):
        parts = [struct.pack("<BI", _T_LIST, len(v))]
        parts += [_pack_value(x) for x in v]
        return b"".join(parts)
    arr = np.ascontiguousarray(v)
    if arr.dtype.kind not in _DTYPE_ALLOW:
        raise TypeError(f"graph wire protocol cannot carry dtype {arr.dtype}")
    dt = arr.dtype.str.encode("ascii")
    hdr = struct.pack("<BBB", _T_NDARRAY, len(dt), arr.ndim)
    shape = struct.pack(f"<{arr.ndim}q", *arr.shape)
    return hdr + dt + shape + arr.tobytes()


def _unpack_value(buf: memoryview, off: int):
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_BOOL:
        return bool(buf[off]), off + 1
    if tag == _T_INT:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag == _T_STR:
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]).decode("utf-8"), off + n
    if tag == _T_LIST:
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        out = []
        for _ in range(n):
            v, off = _unpack_value(buf, off)
            out.append(v)
        return out, off
    if tag == _T_NDARRAY:
        dt_len, ndim = buf[off], buf[off + 1]
        off += 2
        dt = np.dtype(bytes(buf[off:off + dt_len]).decode("ascii"))
        off += dt_len
        if dt.kind not in _DTYPE_ALLOW:
            raise TypeError(f"refusing wire dtype {dt}")
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * dt.itemsize
        arr = np.frombuffer(buf[off:off + nbytes], dtype=dt).reshape(shape)
        return arr.copy(), off + nbytes
    raise ValueError(f"unknown wire tag {tag}")


def _pack_fields(fields: Dict[str, object]) -> bytes:
    parts = [struct.pack("<I", len(fields))]
    for k, v in fields.items():
        raw = k.encode("utf-8")
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
        parts.append(_pack_value(v))
    return b"".join(parts)


def _unpack_fields(payload: bytes) -> Dict[str, object]:
    buf = memoryview(payload)
    n = struct.unpack_from("<I", buf, 0)[0]
    off = 4
    out: Dict[str, object] = {}
    for _ in range(n):
        klen = struct.unpack_from("<I", buf, off)[0]
        off += 4
        k = bytes(buf[off:off + klen]).decode("utf-8")
        off += klen
        v, off = _unpack_value(buf, off)
        out[k] = v
    return out


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> bytes:
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("graph service closed")
        hdr += chunk
    n = struct.unpack("<Q", hdr)[0]
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("graph service closed")
        buf += chunk
    return bytes(buf)


# remote-callable surface: dispatch NEVER getattrs an attacker-chosen
# name, and host-side file I/O (save/load) is deliberately NOT remote
_SERVICE_OPS = frozenset({
    "add_graph_node", "add_edges", "set_node_feat", "build",
    "sample_neighbors", "random_sample_nodes", "get_node_feat", "degree",
})


class GraphService:
    """Serve a GraphTable over TCP (threaded; sampling is numpy work that
    releases the GIL in the hot loops). Wire format: typed struct+numpy
    fields — see the module docstring's trust model."""

    def __init__(self, table: GraphTable, host: str = "127.0.0.1",
                 port: int = 0):
        self.table = table
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.endpoint = "%s:%d" % self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.2)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn):
        try:
            while True:
                req = _unpack_fields(_recv_msg(conn))
                op = req.pop("op", None)
                if not isinstance(op, str):
                    _send_msg(conn, _pack_fields(
                        {"ok": False, "error": "request missing 'op'"}))
                    continue
                if op == "stop":
                    _send_msg(conn, _pack_fields({"ok": True}))
                    return
                try:
                    if op not in _SERVICE_OPS:
                        raise ValueError(f"unknown graph op {op!r}")
                    out = getattr(self.table, op)(**req)
                    if isinstance(out, tuple):
                        out = list(out)
                    _send_msg(conn, _pack_fields({"ok": True,
                                                  "result": out}))
                except Exception as e:            # report, keep serving
                    _send_msg(conn, _pack_fields({"ok": False,
                                                  "error": repr(e)}))
        except (ConnectionError, EOFError, ValueError, KeyError,
                IndexError, TypeError, struct.error):
            # disconnected peer or an unparseable frame (truncated payload,
            # bad tag): close THIS connection quietly; the server and other
            # connections keep serving
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


class GraphClient:
    """Remote GraphTable with the SAME method surface (reference:
    GraphBrpcClient)."""

    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=30)
        self._lock = threading.Lock()

    def _call(self, op: str, **kw):
        with self._lock:
            _send_msg(self._sock, _pack_fields({"op": op, **kw}))
            resp = _unpack_fields(_recv_msg(self._sock))
        if not resp.get("ok"):
            raise RuntimeError(f"graph service error: {resp.get('error')}")
        out = resp.get("result")
        # multi-array results (sample_neighbors) travel as a list
        if isinstance(out, list) and out and all(
                isinstance(x, np.ndarray) for x in out):
            return tuple(out)
        return out

    def add_graph_node(self, node_type, ids):
        return self._call("add_graph_node", node_type=node_type, ids=ids)

    def add_edges(self, edge_type, src, dst):
        return self._call("add_edges", edge_type=edge_type, src=src,
                          dst=dst)

    def set_node_feat(self, feat_name, ids, rows):
        return self._call("set_node_feat", feat_name=feat_name, ids=ids,
                          rows=rows)

    def build(self):
        return self._call("build")

    def sample_neighbors(self, edge_type, ids, sample_size,
                         replace=False):
        return self._call("sample_neighbors", edge_type=edge_type,
                          ids=ids, sample_size=sample_size,
                          replace=replace)

    def random_sample_nodes(self, node_type, sample_size):
        return self._call("random_sample_nodes", node_type=node_type,
                          sample_size=sample_size)

    def get_node_feat(self, feat_name, ids):
        return self._call("get_node_feat", feat_name=feat_name, ids=ids)

    def degree(self, edge_type, ids):
        return self._call("degree", edge_type=edge_type, ids=ids)

    def close(self):
        try:
            self._call("stop")
        except Exception:
            pass
        self._sock.close()
