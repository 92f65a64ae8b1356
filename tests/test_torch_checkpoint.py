"""The port's single-process checkpoint commit protocol
(``paddle_tpu_torch.distributed.checkpoint``), drain snapshots and
adapter checkpoints against the JAX package on the CPU.

A committed directory is staged in ``<path>.tmp``, renamed into place
(a replaced one parked under ``.old`` for the swap) and verified at
each ``FLAGS_checkpoint_verify`` level; files cross at the manifest:
the JAX ``verify_checkpoint`` / ``read_manifest`` accept what the port
commits, with the JAX package's ``leaves`` keys for the same state, and
a drain snapshot written by either package loads in the other. Adapter
checkpoints load into a LoRA manager or leave it untouched; a
``TrainStep`` restored from ``save_train_step`` continues bit-equal.

Tolerances: none, every comparison is exact.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_checkpoint.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.serving import resilience as jres
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import BertForMaskedLM, bert_tiny
from paddle_tpu_torch.monitor import flight_recorder as tflight
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (LoRAManager, Request,
                                      load_drain_snapshot,
                                      requests_from_snapshot,
                                      save_adapter_checkpoint,
                                      save_drain_snapshot)
from paddle_tpu_torch.testing import chaos as tchaos


@pytest.fixture(autouse=True)
def _port_isolation():
    """The port's chaos injector and flight recorder, reset around each
    case (the conftest resets the JAX package's)."""
    tchaos.reset()
    tflight.set_flight_recorder(None)
    yield
    tchaos.reset()
    tflight.set_flight_recorder(None)


def _state(rng, lib):
    """The same nested state in either package's arrays: dicts (keys
    out of order), a list, a tuple, a None node, scalars and a string."""
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    ids = rng.integers(0, 9, (5,)).astype(np.int32)
    arr = jnp.asarray if lib == "jax" else torch.from_numpy
    return {"params": {"gpt.wte.weight": arr(w), "gpt.ln.bias": arr(b)},
            "opt": [arr(w * 2), (arr(b * 3), None)],
            "ids": arr(ids), "step_count": 3, "lr": 0.5, "tag": "x"}


# -- the commit protocol -------------------------------------------------------------
def test_commit_stages_renames_and_swaps_through_old(tmp_path, monkeypatch):
    """A save stages into ``.tmp`` and renames into place; a second save
    to the same path parks the first under ``.old`` for the swap and
    deletes it after; only the committed name remains."""
    path = str(tmp_path / "ck")
    seen = []
    real_rename = os.rename

    def rename(src, dst):
        seen.append((os.path.basename(src), os.path.basename(dst),
                     sorted(os.listdir(str(tmp_path)))))
        real_rename(src, dst)
    monkeypatch.setattr(os, "rename", rename)
    rng = np.random.default_rng(0)
    tckpt.save(_state(rng, "torch"), path, step=1, asynchronous=False)
    assert seen == [("ck.tmp", "ck", ["ck.tmp"])]
    m1 = tckpt.read_manifest(path)
    tckpt.save(_state(rng, "torch"), path, step=2, asynchronous=False)
    assert [s[:2] for s in seen[1:]] == [("ck", "ck.old"), ("ck.tmp", "ck")]
    assert sorted(os.listdir(str(tmp_path))) == ["ck"]
    m2 = tckpt.read_manifest(path)
    assert (m1["step"], m2["step"]) == (1, 2)
    assert m2["format"] == 1 and set(m2["files"]) == {tckpt.STATE_NAME}
    assert m2["flags"]["checkpoint_verify"] == "manifest"
    assert "crc32" not in m2["files"][tckpt.STATE_NAME]
    assert tckpt.verify_checkpoint(path) is None
    got = tckpt.load(path)
    assert got["step_count"] == 3 and got["tag"] == "x"
    assert got["opt"][1][1] is None
    assert isinstance(got["params"]["gpt.wte.weight"], torch.Tensor)


@pytest.mark.parametrize("fault", ["torn", "missing", "corrupt_manifest",
                                   "no_manifest", "bitflip"])
def test_verify_catches_each_fault_at_its_level(tmp_path, fault):
    """Each level catches what it checks: ``manifest`` a torn or
    missing file and an unreadable or absent manifest, ``full`` also a
    flipped bit (CRCs recorded under ``full``), ``off`` only existence."""
    path = str(tmp_path / "ck")
    with flag_scope("checkpoint_verify", "full"):
        tckpt.save(_state(np.random.default_rng(1), "torch"), path,
                   extra_files={"note.txt": "hello"}, asynchronous=False)
    data = os.path.join(path, tckpt.STATE_NAME)
    mpath = os.path.join(path, tckpt.MANIFEST_NAME)
    if fault == "torn":
        with open(data, "r+b") as f:
            f.truncate(os.path.getsize(data) // 2)
    elif fault == "missing":
        os.remove(os.path.join(path, "note.txt"))
    elif fault == "corrupt_manifest":
        with open(mpath, "wb") as f:
            f.write(b"\x00garbage\x00")
    elif fault == "no_manifest":
        os.remove(mpath)
    else:
        with open(data, "r+b") as f:
            f.seek(40)
            byte = f.read(1)
            f.seek(40)
            f.write(bytes([byte[0] ^ 1]))
    want = {"torn": "torn file", "missing": "file missing",
            "corrupt_manifest": "manifest unreadable",
            "no_manifest": "uncommitted", "bitflip": "checksum mismatch"}
    assert want[fault] in tckpt.verify_checkpoint(path, level="full")
    manifest_level = tckpt.verify_checkpoint(path, level="manifest")
    if fault == "bitflip":
        assert manifest_level is None
    else:
        assert want[fault] in manifest_level
        with pytest.raises(tckpt.CheckpointError):
            tckpt.load(path)
    assert tckpt.verify_checkpoint(path, level="off") is None
    assert tckpt.verify_checkpoint(str(tmp_path / "nope")) \
        == "missing (not a directory)"


def test_chaos_torn_commit_and_latest_step_skips_it(tmp_path):
    """``ckpt.write.torn`` tears the last step's data file after its size
    was recorded: ``latest_step`` falls back to the step before with a
    ``checkpoint_fallback`` flight event, as the JAX reader does on the
    same directories; ``ckpt.manifest.corrupt`` is caught too."""
    root = str(tmp_path)
    rng = np.random.default_rng(2)
    for n in (1, 2):
        tckpt.save(_state(rng, "torch"), os.path.join(root, f"step_{n}"),
                   step=n, asynchronous=False)
    with tchaos.chaos_scope("ckpt.write.torn@1"):
        tckpt.save(_state(rng, "torch"), os.path.join(root, "step_3"),
                   step=3, asynchronous=False)
    os.makedirs(os.path.join(root, "step_4.tmp"))     # a killed save
    assert tckpt.checkpoint_steps(root) == [1, 2, 3]
    with flag_scope("flight_recorder", True):
        assert tckpt.latest_step(root) == 2
        ev = [e for e in tflight.get_flight_recorder().events
              if e["event"] == "checkpoint_fallback"]
    assert [(e["step"], e["fallback_to"]) for e in ev] == [(3, 2)]
    assert "torn file" in ev[0]["reason"]
    assert jckpt.latest_step(root) == 2
    with tchaos.chaos_scope("ckpt.manifest.corrupt@1"):
        tckpt.save(_state(rng, "torch"), os.path.join(root, "step_5"),
                   step=5, asynchronous=False)
    assert tckpt.latest_step(root) == 2
    assert "manifest unreadable" in tckpt.verify_checkpoint(
        os.path.join(root, "step_5"))


def test_load_target_and_async_are_documented_gaps(tmp_path):
    """Async saves and ``load(target=)``, once gaps, now ported: an async
    save is written in the background and not visible until ``wait()``
    commits it (then both packages' readers accept it); a target gives
    each leaf the form it declares (a tensor's dtype, a ``Layout``)."""
    path = str(tmp_path / "ck")
    a = torch.arange(8.0).reshape(2, 4)
    tckpt.save({"a": a, "b": torch.ones(2)}, path, asynchronous=True)
    tckpt.Checkpointer.instance()._pending.thread.join()
    assert tckpt.verify_checkpoint(path) == "missing (not a directory)"
    tckpt.wait()
    assert tckpt.verify_checkpoint(path) is None
    assert jckpt.verify_checkpoint(path) is None
    got = tckpt.load(path, target={
        "a": tckpt.Layout(dtype=torch.float64),
        "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert got["a"].dtype == torch.float64 and got["b"].dtype == \
        torch.bfloat16
    torch.testing.assert_close(got["a"], a.double(), rtol=0, atol=0)


# -- across the packages -------------------------------------------------------------
def test_jax_reader_accepts_port_dirs_with_equal_leaf_keys(tmp_path):
    """The JAX package's ``verify_checkpoint`` and ``read_manifest``
    accept a directory the port committed, and its ``leaves`` equal
    what the JAX package records for the same state (keys, shapes,
    dtypes, scalar types)."""
    rng = np.random.default_rng(3)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(_state(rng, "jax"), jpath, asynchronous=False, step=7)
    tckpt.save(_state(np.random.default_rng(3), "torch"), tpath, step=7,
               asynchronous=False)
    jm, tm = jckpt.read_manifest(jpath), jckpt.read_manifest(tpath)
    assert tm["leaves"] == jm["leaves"]
    assert list(tm["leaves"]) == list(jm["leaves"])
    assert "['params']['gpt.wte.weight']" in tm["leaves"]
    assert "['opt'][1][0]" in tm["leaves"]
    assert {k for k in tm if k != "flags"} == {k for k in jm if k != "flags"}
    assert tm["step"] == jm["step"] == 7
    for level in ("off", "manifest", "full"):
        assert jckpt.verify_checkpoint(tpath, level=level) is None
    # the JAX reader refuses the port's torn directory as well
    with open(os.path.join(tpath, tckpt.STATE_NAME), "r+b") as f:
        f.truncate(10)
    assert "torn file" in jckpt.verify_checkpoint(tpath, level="manifest")


_SPECS = [
    {"request_id": 4, "prompt": [5, 6, 7], "generated": [8, 9],
     "max_new_tokens": 6, "sampling": {"temperature": 0.0, "top_k": 0,
                                       "top_p": 1.0},
     "eos_token_id": None, "priority": 2, "prefill_pos": 5, "draft": [1],
     "trace_id": "t-1", "trace_parent": "p/1", "trace_process": "r0"},
    {"request_id": 9, "prompt": [1, 2], "generated": [], "max_new_tokens": 3,
     "sampling": {"temperature": 0.7, "top_k": 5, "top_p": 0.9},
     "eos_token_id": 2, "priority": 0, "prefill_pos": 0, "draft": []},
    # nothing left undone: requests_from_snapshot drops it in both
    {"request_id": 11, "prompt": [3], "generated": [4, 4],
     "max_new_tokens": 2, "sampling": {"temperature": 0.0, "top_k": 0,
                                       "top_p": 1.0},
     "eos_token_id": None, "priority": 0, "prefill_pos": 0, "draft": []},
]


def _request_fields(r):
    s = r.sampling
    return (r.prompt.tolist(), r.max_new_tokens,
            (s.temperature, s.top_k, s.top_p), r.eos_token_id, r.deadline_s,
            r.priority, r.trace_id, r.trace_parent, r.trace_process)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_drain_snapshots_load_in_both_packages(tmp_path, writer):
    """A snapshot committed by either package loads in the other with
    the same specs, and ``requests_from_snapshot`` gives equal requests
    (request ids are each package's own). A torn second snapshot falls
    back to the first in both readers."""
    root = str(tmp_path / "drain")
    save = (jres.save_drain_snapshot if writer == "jax"
            else save_drain_snapshot)
    first = save(root, _SPECS)
    assert first.endswith("drain_1")
    chaos = jchaos if writer == "jax" else tchaos
    with chaos.chaos_scope("ckpt.write.torn@1"):
        torn = save(root, _SPECS[:1])
    assert torn.endswith("drain_2")
    for load in (jres.load_drain_snapshot, load_drain_snapshot):
        path, specs = load(root)
        assert path == first and specs == _SPECS
    with open(os.path.join(first, jres.DRAIN_STATE_NAME)) as f:
        doc = json.load(f)
    assert doc["format"] == 1 and doc["requests"] == _SPECS
    jreqs = jres.requests_from_snapshot(_SPECS)
    treqs = requests_from_snapshot(_SPECS)
    assert [_request_fields(r) for r in treqs] \
        == [_request_fields(r) for r in jreqs]
    assert len(treqs) == 2 and treqs[0].prompt.tolist() == [5, 6, 7, 8, 9]
    assert isinstance(treqs[0], Request) and treqs[0].max_new_tokens == 4


# -- adapter checkpoints -------------------------------------------------------------
L, R, E, O = 2, 4, 16, 48


def _manager():
    return LoRAManager(L, E, O, max_adapters=3, rank=R, device="cpu")


def _pools(m):
    return m.a.clone(), m.b.clone(), m.loaded(), m.swaps


def test_lora_checkpoint_round_trip_and_atomic_fail(tmp_path):
    """``save_adapter_checkpoint`` + ``load_adapter(path=)`` fill the same
    pool row bits as ``weights=``; a torn checkpoint, one of the wrong
    shape and one without adapter entries raise and leave the manager
    exactly as it was."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((L, R, E)).astype(np.float32)
    b = rng.standard_normal((L, R, O)).astype(np.float32)
    path = str(tmp_path / "ad")
    save_adapter_checkpoint(path, a, b)
    assert tckpt.verify_checkpoint(path) is None
    assert jckpt.verify_checkpoint(path) is None
    by_path, by_weights = _manager(), _manager()
    row = by_path.load_adapter("x", path=path)
    assert row == by_weights.load_adapter("x", weights=(a, b)) == 1
    assert torch.equal(by_path.a, by_weights.a)
    assert torch.equal(by_path.b, by_weights.b)
    assert torch.equal(by_path.a[:, row], torch.from_numpy(a))
    before = _pools(by_path)
    torn = str(tmp_path / "torn")
    with tchaos.chaos_scope("ckpt.write.torn@1"):
        save_adapter_checkpoint(torn, a, b)
    wrong = str(tmp_path / "wrong")
    save_adapter_checkpoint(wrong, a[:, :2], b[:, :2])
    other = str(tmp_path / "other")
    tckpt.save({"weights": torch.zeros(2)}, other, asynchronous=False)
    for bad, match in ((torn, "failed verification: torn file"),
                       (wrong, "weights are"), (other, "lora_a")):
        with pytest.raises(ValueError, match=match):
            by_path.load_adapter("y", path=bad)
        after = _pools(by_path)
        assert torch.equal(after[0], before[0])
        assert torch.equal(after[1], before[1])
        assert after[2:] == before[2:]
    assert by_path.load_adapter("y", path=path) == 2


# -- TrainStep -------------------------------------------------------------------------
def _bert_batch(vocab, B=2, S=64, M=6, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, S)).astype(np.int64)
    tt = np.zeros((B, S), np.int64)
    mask = np.ones((B, S), np.float32)
    mask[1:, S * 5 // 8:] = 0.0
    ids[mask == 0] = 0
    pos = np.stack([rng.choice(np.arange(1, S * 5 // 8), M, replace=False)
                    for _ in range(B)]).astype(np.int64)
    return [ids, tt, mask, pos]


def test_train_step_checkpoint_continues_bit_equal(tmp_path):
    """Two steps, ``save_train_step``, two more; a fresh model and step
    restored by ``load_train_step`` takes the same two: losses, every
    parameter and every optimizer slot equal the uninterrupted run's
    exactly (dropout on, so the generator state is part of it). The
    manifest's keys are the JAX package's layout for a train step."""
    cfg = bert_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    batch = _bert_batch(cfg.vocab_size)
    labels = np.random.default_rng(1).integers(5, 256, (2, 6))

    def fresh(seed):
        m = BertForMaskedLM(cfg, device="cpu", seed=seed)
        return TrainStep(
            m, lambda layer, i, t, a, p, y: layer.loss(layer(i, t, a, p), y),
            AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01),
            seed=5 if seed == 1 else 9)

    a = fresh(1)
    [a(*batch, labels) for _ in range(2)]
    path = str(tmp_path / "step_2")
    tckpt.save_train_step(a, path, asynchronous=False)
    ref = [float(a(*batch, labels)) for _ in range(2)]
    m = tckpt.read_manifest(path)
    assert m["step"] == 2 and tckpt.latest_step(str(tmp_path)) == 2
    want = {"['params']", "['buffers']", "['opt_state']", "['step_count']",
            "['rng_state']", "['lr']"}
    if not dict(a.layer.named_buffers()):
        want.discard("['buffers']")        # an empty dict has no leaves
    assert {k.split("]")[0] + "]" for k in m["leaves"]} == want
    assert m["leaves"]["['rng_state']"]["dtype"] == "uint8"
    b = fresh(2)                       # other weights and generator seed
    tckpt.load_train_step(b, path)
    assert b.step_count == 2
    got = [float(b(*batch, labels)) for _ in range(2)]
    assert got == ref
    for (k, x), y in zip(a.layer.state_dict().items(),
                         b.layer.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if isinstance(sa[k], torch.Tensor):
            assert torch.equal(sa[k], sb[k]), k
    # a step of another model refuses the checkpoint before any copy
    other = BertForMaskedLM(bert_tiny(num_layers=1), device="cpu", seed=3)
    step = TrainStep(other, lambda *x: None,
                     AdamW(1e-3, parameters=other.parameters()))
    snap = {k: v.clone() for k, v in other.state_dict().items()}
    with pytest.raises(tckpt.CheckpointError, match="parameters"):
        tckpt.load_train_step(step, path)
    for k, v in other.state_dict().items():
        assert torch.equal(v, snap[k])


def test_checkpoint_and_resilience_import_no_jax():
    """The new modules import neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys\n"
            "import paddle_tpu_torch.distributed.checkpoint\n"
            "import paddle_tpu_torch.serving.resilience\n"
            "import paddle_tpu_torch.serving\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parents[1], check=True,
                   timeout=120)
