"""The port's fleet host modules against the JAX package's, on the CPU.

``fleet.utils.fs`` (``LocalFS``, ``HDFSClient``, ``retry_with_backoff``),
``fleet.elastic`` (the heartbeat registry, ``ElasticManager``,
``run_elastic`` around the port's ``TrainStep``), ``fleet.dataset``
(``QueueDataset``, ``InMemoryDataset``), ``fleet.save_persistables`` /
``load_persistables`` and ``auto_parallel``: each test ports the
assertions of the JAX package's own test (``test_fleet_fs.py``,
``test_elastic.py``, ``test_fleet_dataset.py``, ``test_auto_parallel.py``,
``test_distributed_checkpoint.py``, ``test_fault_tolerance.py``) and
runs the JAX module on the same inputs beside the port's. One gloo world
of four ranks (``_torch_fleet_workers``) runs the auto_parallel and
sharded persistables cases; the JAX side lays the same tensors on four
virtual CPU devices.
"""

import pickle
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.fleet import (InMemoryDataset,
                                                QueueDataset, elastic)
from paddle_tpu_torch.distributed.fleet.utils import (HDFSClient, LocalFS,
                                                      fs as tfs)
from paddle_tpu_torch.distributed.spawn_mod import spawn

import _torch_fleet_workers as W

CASES = ("auto_parallel", "persistables")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet_world")
    spawn("_torch_fleet_workers:run", args=(str(out), CASES), nprocs=W.N)
    ranks = []
    for r in range(W.N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _case(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


# -- fs -----------------------------------------------------------------------
def _localfs_trace(fs, d, errors):
    """``test_fleet_fs.py::test_localfs_roundtrip``'s operations; the
    observable results in order."""
    out = []
    fs.mkdirs(str(d))
    out.append(fs.is_dir(str(d)) and fs.is_exist(str(d)))
    f = d / "model.pdparams"
    fs.touch(str(f))
    out.append(fs.is_file(str(f)))
    with pytest.raises(errors.FSFileExistsError):
        fs.touch(str(f), exist_ok=False)
    (d / "sub").mkdir()
    out.append(fs.ls_dir(str(d)))
    out.append(fs.list_dirs(str(d)))
    f.write_text("abc")
    out.append(fs.cat(str(f)))
    fs.mv(str(f), str(d / "renamed"), overwrite=True)
    out.append(fs.is_file(str(d / "renamed")))
    with pytest.raises(errors.FSFileExistsError):
        fs.mv(str(d / "sub"), str(d / "renamed"))
    (d / "sub" / "inner.txt").write_text("x")
    (d / "dst").mkdir()
    (d / "dst" / "stale.txt").write_text("old")
    fs.mv(str(d / "sub"), str(d / "dst"), overwrite=True)
    out.append(fs.is_file(str(d / "dst" / "inner.txt")))
    out.append(fs.is_exist(str(d / "dst" / "stale.txt")))
    src = d / "local.bin"
    src.write_text("data")
    fs.upload(str(src), str(d / "published.bin"))
    out.append(fs.is_file(str(src)) and fs.is_file(str(d / "published.bin")))
    fs.delete(str(d))
    out.append(fs.is_exist(str(d)))
    out.append(fs.need_upload_download())
    return out


def test_localfs_roundtrip_equals_jax(tmp_path):
    """Every LocalFS operation of the JAX test gives the JAX LocalFS's
    result: a touch refuses an existing file, ``mv(overwrite=True)``
    replaces a directory, an upload copies."""
    from paddle_tpu.distributed.fleet.utils import fs as jfs
    got = _localfs_trace(LocalFS(), tmp_path / "port", tfs)
    want = _localfs_trace(jfs.LocalFS(), tmp_path / "jax", jfs)
    assert got == want
    assert got[2] == (["sub"], ["model.pdparams"]) and got[4] == "abc"
    assert got[7] is False and got[-2] is False and got[-1] is False


def test_hdfs_without_cli_fails_fast():
    """No hadoop CLI: ``ExecuteError`` naming it, at once (no retry
    backoff), as the JAX client; the client needs upload/download."""
    client = HDFSClient(hadoop_home="/nonexistent")
    t0 = time.monotonic()
    with pytest.raises(tfs.ExecuteError, match="not found"):
        client.upload("/nonexistent/x", "/remote/x")
    assert time.monotonic() - t0 < 1.0
    assert client.need_upload_download() is True


def _flaky(fails, exc=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise exc("transient")
        return "ok"
    return fn, calls


def test_retry_with_backoff_matches_jax():
    """Three transient failures then success: the same result, attempt
    count and delay schedule (base 0.1 * 2^k, jitter in [1, 1.5)) as the
    JAX helper; a ``retryable = False`` error raises at once without a
    sleep; exhaustion re-raises."""
    from paddle_tpu.distributed.fleet.utils import fs as jfs
    runs = []
    for mod in (tfs, jfs):
        sleeps = []
        fn, calls = _flaky(3)
        out = mod.retry_with_backoff(fn, retries=5, base_delay=0.1,
                                     retry_on=(OSError,),
                                     sleep=sleeps.append)
        runs.append((out, calls["n"], len(sleeps)))
        for k, d in enumerate(sleeps):
            assert 0.1 * 2 ** k <= d < 0.1 * 2 ** k * 1.5
    assert runs[0] == runs[1] == ("ok", 4, 3)

    def permanent():
        e = OSError("no such CLI")
        e.retryable = False
        raise e
    with pytest.raises(OSError, match="no such CLI"):
        tfs.retry_with_backoff(permanent, retries=5, retry_on=(OSError,),
                               sleep=lambda s: pytest.fail("slept"))
    fn, calls = _flaky(10)
    with pytest.raises(OSError, match="transient"):
        tfs.retry_with_backoff(fn, retries=2, retry_on=(OSError,),
                               sleep=lambda s: None)
    assert calls["n"] == 3


# -- elastic ------------------------------------------------------------------
def _watch_trace(mod, root):
    """``test_elastic.py::test_watch_states`` and the stale-heartbeat
    case, the statuses in order."""
    mgr = mod.ElasticManager(root=str(root), rank=0, np_=2, min_np=1,
                             max_np=2, timeout=60)
    out = [mgr.watch()]
    mgr.beat()
    out.append(mgr.watch())
    other = mod.ElasticManager(root=str(root), rank=1, np_=2, min_np=1,
                               max_np=2, timeout=60)
    other.beat()
    out += [mgr.watch(), mgr.alive_workers()]
    mgr.mark_completed()
    out.append(mgr.watch())
    stale = mod.ElasticManager(root=str(root / "stale"), rank=0, np_=1,
                               min_np=1, max_np=1, timeout=0.0)
    stale.beat()
    out += [stale.alive_workers(), stale.watch()]
    return out


def test_elastic_watch_states_equal_jax(tmp_path, monkeypatch):
    """ERROR with nobody alive, RESTART with one of two (min 1), HOLD
    with both, COMPLETED after the marker, a stale heartbeat dead: as
    the JAX manager. A heartbeat write goes through the store retry
    (``retry_on=(OSError,)``)."""
    from paddle_tpu.distributed.fleet import elastic as jel
    got = _watch_trace(elastic, tmp_path / "port")
    assert got == _watch_trace(jel, tmp_path / "jax")
    assert got == ["error", "restart", "hold", [0, 1], "completed", [],
                   "error"]
    seen = {}
    real = tfs.retry_with_backoff

    def spy(fn, **kw):
        seen.update(kw)
        return real(fn, **kw)
    monkeypatch.setattr(tfs, "retry_with_backoff", spy)
    elastic.ElasticManager(root=str(tmp_path / "spy"), rank=0, np_=1,
                           timeout=60).beat()
    assert seen["retry_on"] == (OSError,)


def _elastic_run(tmp_path, crash_at):
    """``test_elastic.py::test_run_elastic_resumes_from_checkpoint`` on
    the port's ``TrainStep`` (dropout on, so the resume must restore the
    dropout generator too); the losses of the steps that completed."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layers.common import Linear
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    ckpt = str(tmp_path / f"ck{crash_at}.pkl")
    mgr = elastic.ElasticManager(root=str(tmp_path / f"hb{crash_at}"),
                                 rank=0, np_=1)
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, (8,)).astype(np.int64)
    crash = {"at": crash_at}
    seen = {"resumes": [], "steps": [], "losses": {}}

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a, self.b = Linear(8, 16, "cpu"), Linear(16, 4, "cpu")

        def forward(self, v):
            return self.b(F.dropout(torch.relu(self.a(v)), 0.3,
                                    training=self.training))

    def train(resume):
        seen["resumes"].append(resume is not None)
        torch.manual_seed(3)
        model = Net()
        step = TrainStep(model, lambda m, a, b: F.cross_entropy(m(a), b),
                         Adam(1e-2, parameters=model.parameters()), seed=7)
        if resume:
            step.load(resume)
        while step.step_count < 8:
            loss = float(step(x, y))
            seen["steps"].append(step.step_count)
            seen["losses"][step.step_count] = loss
            step.save(ckpt)
            if step.step_count == crash["at"]:
                crash["at"] = 0
                raise RuntimeError("injected worker failure")
        return loss
    naps = []
    final = elastic.run_elastic(train, ckpt, max_restarts=2, manager=mgr,
                                sleep=naps.append)
    return final, seen, naps


def test_run_elastic_resumes_bit_exact(tmp_path):
    """A failure after step 4: the supervisor waits 2 s (recorded, not
    slept) and resumes from the step-4 checkpoint; steps 1-8 each run
    once and every loss, the final one included, equals an uninterrupted
    run's bit for bit. Past ``max_restarts`` the error is raised."""
    final, seen, naps = _elastic_run(tmp_path, 4)
    ref, ref_seen, _ = _elastic_run(tmp_path, 0)
    assert seen["resumes"] == [False, True] and naps == [2.0]
    assert seen["steps"] == list(range(1, 9))
    assert seen["losses"] == ref_seen["losses"] and final == ref
    mgr = elastic.ElasticManager(root=str(tmp_path / "hbx"), rank=0, np_=1)

    def always_fail(resume):
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        elastic.run_elastic(always_fail, str(tmp_path / "none.pkl"),
                            max_restarts=1, manager=mgr,
                            sleep=lambda s: None)


# -- dataset ------------------------------------------------------------------
def _write_multislot(path, rows):
    with open(path, "w") as f:
        for label, feats in rows:
            f.write(f"1 {label} {len(feats)} " +
                    " ".join(str(v) for v in feats) + "\n")


def _dataset_runs(mods, tmp_path):
    """``test_fleet_dataset.py``'s four cases through each module pair
    ``(QueueDataset, InMemoryDataset)``; every batch and count."""
    rows = [(i % 2, [i, i + 0.5]) for i in range(7)]
    _write_multislot(tmp_path / "a.txt", rows[:4])
    _write_multislot(tmp_path / "b.txt", rows[4:])
    _write_multislot(tmp_path / "d.txt", [(i, [float(i)]) for i in range(20)])
    with open(tmp_path / "raw.txt", "w") as f:
        f.write("x 1,2\nx 3,4\n")
    out = []
    for Queue, InMem in mods:
        res = {}
        ds = Queue()
        ds.init(batch_size=3)
        ds.set_filelist([str(tmp_path / "a.txt"), str(tmp_path / "b.txt")])
        res["queue"] = [[b.tolist() for b in batch] for batch in ds]
        ds = InMem()
        ds.init(batch_size=5, drop_last=True)
        ds.set_filelist([str(tmp_path / "d.txt")])
        ds.load_into_memory()
        res["size"] = ds.get_memory_data_size()
        res["first"] = [b[0][:, 0].tolist() for b in ds]
        ds.local_shuffle()
        res["second"] = [b[0][:, 0].tolist() for b in ds]
        ds.global_shuffle()
        res["global"] = (ds.get_shuffle_data_size(),
                         [b[0][:, 0].tolist() for b in ds])
        ds.release_memory()
        res["released"] = ds.get_memory_data_size()
        ds = Queue()
        ds.init(batch_size=2, pipe_command="sed 's/^x //'",
                parse_fn=lambda line: [np.asarray(
                    [float(v) for v in line.split(",")], np.float32)])
        ds.set_filelist([str(tmp_path / "raw.txt")])
        res["pipe"] = [[b.tolist() for b in batch] for batch in ds]
        out.append(res)
    return out


def test_datasets_equal_jax(tmp_path):
    """The MultiSlot parser, batching (a short last batch, or dropped),
    the in-memory local and global shuffles (the same seeded orders),
    the memory accounting and a real ``pipe_command`` pipeline give the
    JAX datasets' batches exactly."""
    from paddle_tpu.distributed.fleet import InMemoryDataset as JIn
    from paddle_tpu.distributed.fleet import QueueDataset as JQ
    got, want = _dataset_runs([(QueueDataset, InMemoryDataset),
                               (JQ, JIn)], tmp_path)
    assert got == want
    assert len(got["queue"]) == 3 and len(got["queue"][-1][0]) == 1
    assert got["queue"][0][0] == [[0.0], [1.0], [0.0]]
    assert got["size"] == 20 and got["released"] == 0
    assert got["first"] != got["second"]
    assert sorted(sum(got["first"], [])) == sorted(sum(got["second"], []))
    assert got["global"][0] == 20
    assert got["pipe"] == [[[[1.0, 2.0], [3.0, 4.0]]]]


def test_multislot_parser_refuses_a_short_line():
    from paddle_tpu_torch.distributed.fleet.dataset import _parse_multislot
    assert [a.tolist() for a in _parse_multislot("2 1 2 1 5")] == \
        [[1.0, 2.0], [5.0]]
    with pytest.raises(ValueError, match="corrupt MultiSlot"):
        _parse_multislot("3 1 2")


# -- the world: auto_parallel and sharded persistables -------------------------
def _jax_blocks():
    """The JAX auto_parallel placements of the same tensors on four
    virtual devices: device id -> shard, per placement."""
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.distributed.auto_parallel import (ProcessMesh, reshard,
                                                      shard_tensor)
    devs = jax.devices()[:4]
    a, b = ProcessMesh(*W.MESH_A), ProcessMesh(*W.MESH_B)

    def blocks(t):
        return {s.device.id: np.asarray(s.data)
                for s in t._data.addressable_shards if s.device in devs}
    out = {"xy": blocks(shard_tensor(paddle.to_tensor(W.DATA),
                                     process_mesh=a, dims_mapping=[0, 1])),
           "x_": blocks(shard_tensor(paddle.to_tensor(W.DATA),
                                     process_mesh=a, dims_mapping=[0, -1]))}
    r = reshard(shard_tensor(paddle.to_tensor(W.DATA), process_mesh=a,
                             dims_mapping=[0, -1]),
                process_mesh=b, dims_mapping=[1, 0])
    out["b"] = blocks(r)
    out["b_spec"] = tuple(r._data.sharding.spec)
    return out


def test_auto_parallel_blocks_equal_the_jax_shards(world):
    """Rank r's block equals the JAX shard on device r: ``shard_tensor``
    by ``[0, 1]`` (4 x 8 of 8 x 16) and ``[0, -1]`` over mesh A,
    ``reshard`` to mesh B (other names and process order) by ``[1, 0]``
    (spec ``("q", "p")``), and back to A replicated (the whole tensor);
    the dict form over a nested list, ``shard_op``'s inputs (the op
    sees each rank's 2 x 6 rows) and the mesh scope behave as in JAX."""
    want = _jax_blocks()
    for rank, r in enumerate(_case(world, "auto_parallel")):
        assert r["shape"] == [2, 2] and r["names"] == ["x", "y"]
        assert r["ids"] == [3, 2, 1, 0] and r["axes"] == ("x", "y")
        assert r["coords"] == (1 - rank // 2, 1 - rank % 2)
        for key in ("xy", "x_", "b"):
            np.testing.assert_array_equal(r[key], want[key][rank])
        assert r["b_spec"] == want["b_spec"] == ("q", "p")
        np.testing.assert_array_equal(r["back"], W.DATA)
        assert r["dict"] == (2, 6) and r["op_x"] == (2, 6)
        np.testing.assert_array_equal(r["op"], np.ones((2, 6)))
        assert r["active"] and r["after"]


def test_sharded_persistables_round_trip(world):
    """dp = 2 x mp = 2: a ``TrainStep`` saved with ``save_persistables``
    (one ``shard_rank<r>`` file a rank) and loaded into a step of another
    seed holds the same parameters and takes the same next step; a
    mesh-laid layer's parameters and buffers round-trip in its layout.
    The JAX ``verify_checkpoint`` accepts both directories."""
    from paddle_tpu.distributed.checkpoint import verify_checkpoint
    res = _case(world, "persistables")
    for r in res:
        assert r["equal"] and r["next"][0] == r["next"][1]
        assert r["layer_equal"] and r["layer_block"] == (64, 3, 2, 16)
    assert sum(f.startswith("shard_rank") for f in res[0]["files"]) == 4
    for path in res[0]["paths"]:
        assert verify_checkpoint(path) is None


def test_layer_persistables_in_one_process(tmp_path):
    """Without a mesh a layer saves its parameters and buffers whole; a
    fresh layer loads them; a layer of other names is refused."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.layers.common import Linear
    torch.manual_seed(0)
    lin = Linear(4, 4, "cpu")
    fleet.save_persistables(lin, str(tmp_path / "p"), asynchronous=False)
    lin2 = Linear(4, 4, "cpu")
    fleet.load_persistables(lin2, str(tmp_path / "p"))
    assert torch.equal(lin2.weight, lin.weight)
    with pytest.raises(ValueError, match="lacks"):
        fleet.load_persistables(torch.nn.Sequential(torch.nn.Linear(4, 4)),
                                str(tmp_path / "p"))
