"""The port's ``CheckpointManager`` and sharded, resharding checkpoints
(``paddle_tpu_torch.distributed.checkpoint``), mirroring the JAX
package's ``tests/test_fault_tolerance.py`` manager cases and
``tests/test_distributed_checkpoint.py``'s reshard cases on the CPU.

Single process: interval saves and retention (``keep_n`` newest, the
last valid one never deleted, orphan staging directories removed); an
async interval save committed at the first step boundary after its files
are down; SIGTERM latched and honoured at the next boundary with a final
synchronous commit and ``PreemptionSignal``, the resumed run bit-exact
with the uninterrupted one (the dataloader position from the sidecar);
the final commit made even after a failed async save; ``resume()``
falling back past a torn checkpoint with the ``checkpoint_fallback``
event naming the step it landed on; the sidecar inside the manifest;
goodput's ``checkpoint_stall`` and ``restart_gap`` fed.

A gloo world of four ranks (``_torch_p2b_workers``): ERNIE at sharding =
2 x mp = 2 saved sharded (async, visible only after ``wait()``): each
rank writes its own blocks, the bytes on disk within 1.5x of the logical
state (not one copy a replica), the JAX ``verify_checkpoint`` and
``read_manifest`` accept the directory; resumed at the same layout the
run is bit-exact, at mp = 4 and in one process the losses are within
1e-5 (relative) of the uninterrupted run.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_checkpoint_manager.py``.
"""

import json
import os
import pickle
import signal
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.distributed import checkpoint as dckpt
from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                     PreemptionSignal,
                                                     latest_step,
                                                     verify_checkpoint)
from paddle_tpu_torch.distributed.spawn_mod import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.monitor import flight_recorder as flight
from paddle_tpu_torch.monitor import goodput
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.testing import chaos

N = 4
CASES = ("reshard",)
ERNIE = dict(vocab_size=512, hidden_size=64, num_heads=4,
             intermediate_size=128, num_layers=2, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _port_isolation():
    chaos.reset()
    flight.set_flight_recorder(None)
    yield
    chaos.reset()
    flight.set_flight_recorder(None)
    dckpt.Checkpointer.instance()._pending = None


def _build_step(**kwargs):
    g = torch.Generator().manual_seed(3)
    model = torch.nn.Sequential(Linear(8, 16), torch.nn.ReLU(),
                                Linear(16, 4))
    for m in model:
        if isinstance(m, Linear):
            m.reset_parameters(g)
    return TrainStep(model, lambda l, a, b: F.cross_entropy(l(a), b),
                     Adam(1e-2, parameters=model.parameters()), **kwargs)


def _batch(i):
    rng = np.random.default_rng(50 + i)
    return (torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 4, (8,))))


def _ref_losses(n):
    step = _build_step()
    return [float(step(*_batch(i))) for i in range(n)]


def test_preemption_resume_is_bit_exact(tmp_path):
    """SIGTERM mid-run -> the final commit at the next step boundary ->
    a fresh step's ``resume()``: the remaining losses equal the
    uninterrupted run's bit for bit (parameters, slots, generator and
    the dataloader offset restored)."""
    root = str(tmp_path / "ckpts")
    ref = _ref_losses(6)
    step_a = _build_step()
    losses_a = []
    with pytest.raises(PreemptionSignal) as exc:
        with CheckpointManager(step_a, root, interval_steps=2,
                               keep_n=2) as mgr:
            for i in range(6):
                losses_a.append(float(step_a(*_batch(i))))
                if i == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
                mgr.on_step(dataloader_state={"offset": i + 1})
    assert exc.value.step == 4 and exc.value.path.endswith("step_4")
    assert losses_a == ref[:4]
    step_b = _build_step()
    with CheckpointManager(step_b, root, interval_steps=2, keep_n=2) as mgr:
        info = mgr.resume()
        assert info["step"] == 4 and info["dataloader"] == {"offset": 4}
        losses_b = [float(step_b(*_batch(i)))
                    for i in range(info["dataloader"]["offset"], 6)]
    assert losses_b == ref[4:]
    assert signal.getsignal(signal.SIGTERM) is not mgr._on_signal


def test_preemption_commits_despite_prior_failed_async_save(tmp_path,
                                                            monkeypatch):
    """A failed async interval save does not stop the SIGTERM commit."""
    root = str(tmp_path / "ckpts")
    real_commit = dckpt._commit

    def flaky_commit(tmp, final, *a, **k):
        if final.endswith("step_2"):
            raise OSError("transient store failure")
        return real_commit(tmp, final, *a, **k)
    monkeypatch.setattr(dckpt, "_commit", flaky_commit)
    step = _build_step()
    with pytest.raises(PreemptionSignal) as exc:
        with CheckpointManager(step, root, interval_steps=2,
                               keep_n=2) as mgr:
            for i in range(3):
                step(*_batch(i))
                if i == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                mgr.on_step()
    assert exc.value.step == 3
    assert latest_step(root) == 3
    assert not os.path.exists(os.path.join(root, "step_2"))


def test_manager_interval_saves_and_gc(tmp_path):
    root = str(tmp_path / "ckpts")
    step = _build_step()
    with CheckpointManager(step, root, interval_steps=2, keep_n=2,
                           asynchronous=False) as mgr:
        for i in range(8):
            step(*_batch(i))
            mgr.on_step()
    assert dckpt.checkpoint_steps(root) == [6, 8]
    assert all(verify_checkpoint(os.path.join(root, f"step_{n}")) is None
               for n in (6, 8))
    assert mgr.save_count == 4


def test_async_interval_save_commits_at_next_step_boundary(tmp_path):
    """An async interval save is not visible when ``on_step`` returns;
    it commits at the first step boundary after its files are down, not
    at the next interval."""
    root = str(tmp_path / "ckpts")
    step = _build_step()
    with CheckpointManager(step, root, interval_steps=4, keep_n=2) as mgr:
        for i in range(4):
            step(*_batch(i))
            mgr.on_step()
        deadline = time.monotonic() + 30.0
        ckpt = dckpt.Checkpointer.instance()
        while not ckpt.pending_ready() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert latest_step(root) is None     # written, not committed
        step(*_batch(4))
        mgr.on_step()                        # step 5 commits step_4
        assert latest_step(root) == 4
        assert verify_checkpoint(os.path.join(root, "step_4")) is None


def test_resume_fallback_event_names_landing_step(tmp_path):
    """A torn newest checkpoint: ``resume()`` lands on the one before,
    and its ``checkpoint_fallback`` event says where."""
    root = str(tmp_path / "ckpts")
    step = _build_step()
    mgr = CheckpointManager(step, root, interval_steps=1, keep_n=3,
                            asynchronous=False)
    try:
        step(*_batch(0))
        mgr.save()
        step(*_batch(1))
        chaos.configure("ckpt.write.torn@1")
        mgr.save()
        chaos.reset()
    finally:
        mgr.close()
    fresh = _build_step()
    mgr2 = CheckpointManager(fresh, root, interval_steps=1)
    try:
        with flag_scope("flight_recorder", True):
            info = mgr2.resume()
            events = flight.get_flight_recorder().events
    finally:
        mgr2.close()
    assert info["step"] == 1 and fresh.step_count == 1
    fb = [e for e in events if e["event"] == "checkpoint_fallback"]
    assert fb and fb[0]["step"] == 2 and fb[0]["fallback_to"] == 1


def test_gc_never_deletes_last_valid(tmp_path):
    root = str(tmp_path / "ckpts")
    step = _build_step()
    step(*_batch(0))
    mgr = CheckpointManager(step, root, interval_steps=1, keep_n=1,
                            asynchronous=False)
    try:
        mgr.save()
        mgr.gc()
        assert dckpt.checkpoint_steps(root) == [1]
        os.makedirs(os.path.join(root, "step_9.tmp"))
        mgr.gc()
        assert not os.path.exists(os.path.join(root, "step_9.tmp"))
        assert dckpt.checkpoint_steps(root) == [1]
    finally:
        mgr.close()


def test_worker_die_site_raises_chaos_fault(tmp_path):
    step = _build_step()
    mgr = CheckpointManager(step, str(tmp_path), interval_steps=100)
    try:
        chaos.configure("worker.die@2")
        step(*_batch(0))
        mgr.on_step()
        step(*_batch(1))
        with pytest.raises(chaos.ChaosFault) as exc:
            mgr.on_step()
        assert exc.value.site == "worker.die"
    finally:
        mgr.close()


def test_manager_sidecar_is_committed_and_covered(tmp_path):
    """The sidecar (dataloader position) is in the manifest's files: a
    torn sidecar invalidates the checkpoint; the JAX reader accepts the
    directory."""
    root = str(tmp_path / "ckpts")
    step = _build_step()
    step(*_batch(0))
    mgr = CheckpointManager(step, root, interval_steps=1,
                            asynchronous=False)
    try:
        path = mgr.save(dataloader_state={"epoch": 1, "offset": 17})
    finally:
        mgr.close()
    m = dckpt.read_manifest(path)
    assert "manager_state.json" in m["files"]
    assert jckpt.verify_checkpoint(path) is None
    with open(os.path.join(path, "manager_state.json")) as f:
        assert json.load(f)["dataloader"] == {"epoch": 1, "offset": 17}
    with open(os.path.join(path, "manager_state.json"), "w") as f:
        f.write("{")
    assert "torn file" in verify_checkpoint(path)


def test_goodput_checkpoint_stall_and_restart_gap_are_fed(tmp_path):
    """Under ``FLAGS_train_goodput`` the manager's saves land in
    ``checkpoint_stall``; its sidecar carries the ledger, and a resumed
    run's ledger restores it with the dead time in ``restart_gap``."""
    root = str(tmp_path / "ckpts")
    goodput.reset()
    try:
        with flag_scope("train_goodput", True):
            step = _build_step()
            with CheckpointManager(step, root, interval_steps=1,
                                   asynchronous=False) as mgr:
                step(*_batch(0))
                mgr.on_step()
                stall = goodput.get_ledger().snapshot()["buckets"][
                    "checkpoint_stall"]
            assert stall > 0
            with open(os.path.join(root, "step_1",
                                   "manager_state.json")) as f:
                assert "goodput" in json.load(f)
            time.sleep(0.05)
            goodput.reset()
            fresh = _build_step()
            with CheckpointManager(fresh, root, interval_steps=1) as mgr2:
                assert mgr2.resume()["step"] == 1
            gap = goodput.get_ledger().snapshot()["buckets"]["restart_gap"]
        assert gap >= 0.05
    finally:
        goodput.reset()


# -- sharded checkpoints on a gloo world ---------------------------------------
def _ernie_batch():
    rng = np.random.RandomState(6)
    B, S, M = 8, 32, 4
    ids = rng.randint(5, ERNIE["vocab_size"], (B, S)).astype(np.int32)
    tt = np.zeros((B, S), np.int32)
    mask = np.ones((B, S), np.int32)
    mask[5, 22:] = 0
    pos = np.stack([rng.choice(16, M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    labels = rng.randint(5, ERNIE["vocab_size"], (B, M)).astype(np.int32)
    w = np.ones((B, M), np.float32)
    sop = rng.randint(0, 2, (B,)).astype(np.int32)
    return ids, tt, mask, pos, labels, w, sop


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("reshard_world")
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"ernie_cfg": ERNIE, "ernie_batch": _ernie_batch()}, f)
    spawn("_torch_p2b_workers:run", args=(str(out), CASES), nprocs=N)
    ranks = []
    for r in range(N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)["reshard"]
        assert not (isinstance(res, str) and res.startswith("FAILED")), res
        ranks.append(res)
    return out, ranks


def test_sharded_save_writes_shards_not_replicas(world):
    """Each rank writes its own blocks: one shard file a rank plus rank
    0's tree, the bytes on disk within 1.5x of the logical state
    (parameters and two moments, f32), the async save invisible until
    ``wait()``; the manifest records global shapes and specs, and the
    JAX ``verify_checkpoint`` / ``read_manifest`` accept the directory."""
    out, ranks = world
    path = str(out / "reshard" / "step_2")
    assert not any(r["visible_before_wait"] for r in ranks)
    names = sorted(os.listdir(path))
    assert names == sorted([dckpt.MANIFEST_NAME, dckpt.STATE_NAME]
                           + [f"shard_rank{r}.pdstate" for r in range(N)])
    logical = 0
    for shape in ranks[0]["local_shapes"]:
        logical += int(np.prod(shape)) * 4 * 3
    # every parameter's whole, not a block: from the manifest
    m = jckpt.read_manifest(path)
    whole = sum(int(np.prod(v["shape"])) * 4 for k, v in m["leaves"].items()
                if k.startswith("['params']"))
    on_disk = sum(os.path.getsize(os.path.join(path, f)) for f in names)
    assert on_disk < 3 * whole * 1.5 + 1e6, (on_disk, whole)
    assert jckpt.verify_checkpoint(path, level="full") is None
    assert m["step"] == 2
    q = m["leaves"]["['params']['ernie.encoder.layers.0.self_attn.q_proj"
                    ".weight']"]
    assert q["shape"] == [64, 64] and q["spec"] == [None, ["mp"]]


def test_same_layout_resume_is_bit_exact(world):
    """Resumed from the sharded checkpoint at sharding = 2 x mp = 2 (a
    fresh model from another seed): the next two losses and every local
    block equal the uninterrupted run's bit for bit."""
    _, ranks = world
    for r in ranks:
        assert r["same"]["step_count"] == 2          # as loaded
        assert r["same"]["losses"] == r["ref"]
        assert r["same"]["params_equal"]


@pytest.mark.parametrize("layout", ["mp4", "one"])
def test_resharded_resume_continues_the_loss_curve(world, layout):
    """Loaded into mp = 4 (each rank other blocks than it saved) and into
    one process: two more steps within 1e-5 (relative) of the
    uninterrupted run's losses."""
    _, ranks = world
    got = ([r["mp4"]["losses"] for r in ranks] if layout == "mp4"
           else [ranks[0]["one"]])
    for losses in got:
        np.testing.assert_allclose(losses, ranks[0]["ref"], rtol=1e-5,
                                   atol=0)
