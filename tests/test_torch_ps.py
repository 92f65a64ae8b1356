"""The port's ``distributed.ps`` against the JAX package's, on the CPU.

The host tables (``SparseTable``, ``SSDSparseTable``), the graph table
and the C++ parameter server with its client and communicators are
copies; these tests hold them to the JAX ones on the same inputs: rows
and log files bit-equal, the port's server (built from the port's own
source into ``paddle_tpu_torch/_build/``) answering with the JAX
server's lazily initialised rows, and ``DistributedEmbedding`` training
against the servers through its anchored autograd node.
"""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.ps import (DistributedEmbedding,
                                             SparseTable, SSDSparseTable)
from paddle_tpu_torch.distributed.ps import service as tsvc
from paddle_tpu_torch.distributed.ps.graph import (GraphClient, GraphService,
                                                   GraphTable)


@pytest.fixture()
def cluster():
    """Two port PS processes and a connected port client (skips where
    g++ cannot build the server, as the JAX tests do)."""
    if not tsvc.native_available():
        pytest.skip("g++ cannot build the PS server here")
    servers = [tsvc.PSServerHandle(), tsvc.PSServerHandle()]
    client = tsvc.PSClient([s.endpoint for s in servers])
    yield servers, client
    client.stop_servers()
    for s in servers:
        assert s.wait(timeout=10) == 0


def test_server_builds_into_the_port_build_dir():
    """The binary is built from the port's copy of the source (the JAX
    source, byte for byte) into ``paddle_tpu_torch/_build/``, named by
    the source hash; a second call reuses it."""
    from paddle_tpu.distributed.ps import service as jsvc
    with open(tsvc._SRC, "rb") as f, open(jsvc._SRC, "rb") as g:
        assert f.read() == g.read()
    path = tsvc._binary_path()
    assert os.path.dirname(path) == os.path.abspath(tsvc._BUILD_DIR)
    assert os.path.basename(path).startswith("ps_server-")
    assert tsvc._binary_path() == path


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile fails the build with the
    compiler's message; there is no fallback."""
    bad = tmp_path / "ps_server.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tsvc, "_SRC", str(bad))
    monkeypatch.setattr(tsvc, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="building the PS server"):
        tsvc.PSServerHandle()
    assert not tsvc.native_available()


def test_port_server_serves_the_jax_servers_rows(cluster):
    """The port's two servers answer the port's client with the same
    lazily initialised rows as two JAX servers with the JAX client, for
    a sparse and a dense table, and apply the same adagrad push."""
    from paddle_tpu.distributed.ps import service as jsvc
    _, client = cluster
    jservers = [jsvc.PSServerHandle(), jsvc.PSServerHandle()]
    jclient = jsvc.PSClient([s.endpoint for s in jservers])
    try:
        keys = np.arange(0, 300, 3, dtype=np.uint64)
        g = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
        for c in (client, jclient):
            c.create_table(1, kind="sparse", dim=8, optimizer="adagrad",
                           lr=0.1, seed=9, init_scale=0.05)
            c.create_table(2, kind="dense", dim=4, rows=3, optimizer="sgd",
                           lr=0.5, seed=3)
        np.testing.assert_array_equal(client.pull_sparse(1, keys, 8),
                                      jclient.pull_sparse(1, keys, 8))
        np.testing.assert_array_equal(client.pull_dense(2, 3, 4),
                                      jclient.pull_dense(2, 3, 4))
        for c in (client, jclient):
            c.push_sparse(1, np.concatenate([keys, keys[:5]]),
                          np.concatenate([g, g[:5]]), grad=True)
        np.testing.assert_array_equal(client.pull_sparse(1, keys, 8),
                                      jclient.pull_sparse(1, keys, 8))
        assert client.num_rows(1) == jclient.num_rows(1) == 100
    finally:
        jclient.stop_servers()
        for s in jservers:
            s.wait(timeout=10)


def test_save_load_async_and_geo(cluster, tmp_path):
    """The copied client paths against the port's servers: a sparse
    table's save / load round trip (one file a server), the async
    communicator's merged pushes, geo-SGD's summed deltas."""
    servers, client = cluster
    client.create_table(3, kind="sparse", dim=8, optimizer="adagrad",
                        lr=0.1, seed=4)
    keys = np.arange(50, dtype=np.uint64)
    client.push_sparse(3, keys, np.ones((50, 8), np.float32), grad=True)
    trained = client.pull_sparse(3, keys, 8)
    client.save(3, str(tmp_path / "ckpt"))
    client.push_sparse(3, keys, np.zeros((50, 8), np.float32), grad=False)
    client.load(3, str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(client.pull_sparse(3, keys, 8), trained)
    assert len(os.listdir(tmp_path / "ckpt")) == 2
    client.create_table(4, kind="sparse", dim=4, optimizer="sgd", lr=1.0,
                        seed=0, init_scale=0.0)
    comm = tsvc.AsyncCommunicator(client, send_every=0.002)
    for _ in range(10):
        comm.push_sparse_grad(4, np.array([7], np.uint64),
                              np.full((1, 4), 0.5, np.float32))
    comm.flush()
    comm.stop()
    np.testing.assert_allclose(
        client.pull_sparse(4, np.array([7], np.uint64), 4), -5.0, atol=1e-5)
    client.create_table(7, kind="sparse", dim=4, optimizer="sgd", lr=1.0,
                        seed=0, init_scale=0.0)
    w1 = tsvc.GeoCommunicator(client, 7, 4, trigger_steps=2)
    w2 = tsvc.GeoCommunicator(client, 7, 4, trigger_steps=2)
    k = np.array([3], np.uint64)
    for _ in range(2):
        w1.update(k, w1.pull(k) + 1.0)
        w1.maybe_sync()
        w2.update(k, w2.pull(k) + 10.0)
        w2.maybe_sync()
    np.testing.assert_allclose(client.pull_sparse(7, k, 4), 22.0, atol=1e-5)
    fresh = tsvc.PSClient([s.endpoint for s in servers])
    assert fresh.table_kind(3) == "sparse" and fresh.table_kind(99) == "absent"
    fresh.close()


def test_distributed_embedding_trains_against_the_servers(cluster):
    """``DistributedEmbedding`` over the port's servers, each step's
    backward pushing through the anchored node, follows the JAX layer
    over the JAX servers step for step (losses within 1e-5 relative)."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.ps import DistributedEmbedding as JDE
    from paddle_tpu.distributed.ps import service as jsvc
    _, client = cluster
    jservers = [jsvc.PSServerHandle()]
    jclient = jsvc.PSClient([s.endpoint for s in jservers])
    try:
        for c in (client, jclient):
            c.create_table(5, kind="sparse", dim=8, optimizer="sgd", lr=1.0,
                           seed=2, init_scale=0.01)
        emb = DistributedEmbedding(1000, 8, client=client, table_id=5,
                                   device="cpu")
        jemb = JDE(1000, 8, client=jclient, table_id=5)
        ids = np.array([[1, 2], [3, 1]], np.int64)
        target = np.ones((2, 2, 8), np.float32)
        losses, jlosses = [], []
        for _ in range(20):
            loss = ((emb(torch.tensor(ids)) - torch.tensor(target)) ** 2) \
                .mean()
            loss.backward()
            losses.append(float(loss.detach()))
            jl = ((jemb(paddle.to_tensor(ids)) - paddle.to_tensor(target))
                  ** 2).mean()
            jl.backward()
            jlosses.append(float(jl))
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert losses[-1] < losses[0] * 0.5
        assert list(emb.parameters()) == []
    finally:
        jclient.stop_servers()
        for s in jservers:
            s.wait(timeout=10)


def test_role_env_protocol(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "pserver")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       "127.0.0.1:1234,127.0.0.1:1235")
    assert tsvc.role_from_env() == "PSERVER"
    assert tsvc.server_endpoints_from_env() == ["127.0.0.1:1234",
                                                "127.0.0.1:1235"]


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_sparse_table_sharded_and_raw_rows_equal_jax(optimizer):
    """A two-shard ``SparseTable`` pair against the JAX one: the same
    seeded rows, the wrong-shard refusal, raw reads and writes, and a
    push's result bit for bit (both numpy)."""
    from paddle_tpu.distributed.ps import SparseTable as J
    for s in (0, 1):
        j = J(11, 4, optimizer=optimizer, lr=0.2, shard_id=s, num_shards=2,
              seed=3)
        t = SparseTable(11, 4, optimizer=optimizer, lr=0.2, shard_id=s,
                        num_shards=2, seed=3)
        ids = np.arange(s, 11, 2)
        np.testing.assert_array_equal(t.pull(ids), j.pull(ids))
        g = np.random.default_rng(s).normal(size=(ids.size * 2, 4)) \
            .astype(np.float32)
        t.push(np.tile(ids, 2), g)
        j.push(np.tile(ids, 2), g)
        np.testing.assert_array_equal(t.data, j.data)
        for a, b in zip(t.read_rows(ids[:2]), j.read_rows(ids[:2])):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="wrong shard"):
            t.pull([1 - s])


def test_ssd_table_log_and_state_equal_jax(tmp_path):
    """``SSDSparseTable`` (a 16-row cache over 200 touched rows) against
    the JAX one: the same lazy rows, spills, log bytes and state."""
    from paddle_tpu.distributed.ps import SSDSparseTable as J
    j = J(10_000, 8, cache_rows=16, path=str(tmp_path / "j.log"), seed=3)
    t = SSDSparseTable(10_000, 8, cache_rows=16, path=str(tmp_path / "t.log"),
                       seed=3)
    ids = np.arange(200)
    np.testing.assert_array_equal(t.pull(ids), j.pull(ids))
    g = np.ones((200, 8), np.float32)
    t.push(ids, g)
    j.push(ids, g)
    assert t.evict_count == j.evict_count > 0
    assert t.log_bytes() == j.log_bytes()
    t._log.flush()
    j._log.flush()
    with open(t.path, "rb") as f, open(j.path, "rb") as h:
        assert f.read() == h.read()
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v)
    t.close()
    j.close()


def test_graph_table_and_service_equal_jax():
    """The graph table and its TCP service answer as the JAX ones: the
    same seeded neighbour samples, degrees and features."""
    from paddle_tpu.distributed.ps.graph import GraphTable as J
    tables = []
    for cls in (J, GraphTable):
        t = cls(seed=0)
        t.add_graph_node("user", [0, 1, 2, 3])
        t.add_edges("follows", src=[0, 0, 0, 1, 2], dst=[1, 2, 3, 2, 3])
        t.build()
        tables.append(t)
    for a, b in zip(tables[0].sample_neighbors("follows", [0, 1, 9], 2),
                    tables[1].sample_neighbors("follows", [0, 1, 9], 2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tables[1].degree("follows", [0, 1, 2, 9]),
                                  [3, 1, 1, 0])
    svc = GraphService(GraphTable(seed=1))
    try:
        c = GraphClient(svc.endpoint)
        c.add_graph_node("item", [10, 11, 12])
        c.add_edges("clicks", src=[10, 10, 11], dst=[11, 12, 12])
        c.build()
        flat, counts = c.sample_neighbors("clicks", [10, 11], sample_size=5)
        assert counts.tolist() == [2, 1] and flat[2] == 12
        c.set_node_feat("f", [10], np.full((1, 3), 7.0, np.float32))
        np.testing.assert_allclose(c.get_node_feat("f", [10]), [[7.0] * 3])
        with pytest.raises(RuntimeError, match="graph service error"):
            c.sample_neighbors("nope", [1], sample_size=1)
        c.close()
    finally:
        svc.stop()
