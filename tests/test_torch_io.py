"""The port's save, load and feed (``paddle_tpu_torch.framework``,
``jit.save`` / ``jit.load``, ``inference.Config(model_path)``,
``TrainStep.save`` / ``load`` and ``io``) against the JAX package on the
CPU, at small sizes (``bert_tiny``, a handful of samples).

Files move both ways: what one package writes, the other reads, plain
and encrypted, a JAX-written bf16 array included (it loads as a torch
bf16 tensor with the same bits). Loaded models and resumed runs are held
bit-equal to the live ones; the samplers and the DataLoader give the
JAX package's index orders and batches after ``np.random.seed``. The
DataLoader's workers start by spawn, so the datasets they receive are
the port's own classes (defined at a module's top level).

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_io.py``.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu.framework import crypto as jcrypto
from paddle_tpu.framework import io as jfio
from paddle_tpu_torch import framework, inference, jit
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import crypto as tcrypto
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import BertForMaskedLM, bert_tiny
from paddle_tpu_torch.optimizer import AdamW

# the int8 kernel's aligned tiny BERT (K and N multiples of 128)
ALIGNED = dict(vocab_size=512, hidden_size=128, num_heads=2,
               intermediate_size=512)
KEY = b"k" * 32


def _batch(vocab, B=2, S=64, M=6, seed=0):
    """ids, token types, a 0/1 float mask (row 1 padded) and masked
    positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, S)).astype(np.int64)
    tt = np.zeros((B, S), np.int64)
    mask = np.ones((B, S), np.float32)
    mask[1:, S * 5 // 8:] = 0.0
    ids[mask == 0] = 0
    pos = np.stack([rng.choice(np.arange(1, S * 5 // 8), M, replace=False)
                    for _ in range(B)]).astype(np.int64)
    return [ids, tt, mask, pos]


# -- framework.save / load and crypto ---------------------------------------------
@pytest.mark.parametrize("key", [None, KEY], ids=["plain", "encrypted"])
def test_framework_files_load_in_both_packages(tmp_path, key):
    """Nested dicts, lists and tuples: the port's tensors arrive in the
    JAX package as numpy arrays (bf16 as its exact f32 widening), and a
    JAX-written file loads in the port as numpy, a bf16 array as a torch
    bf16 tensor with the same bits; exact."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    bf = torch.from_numpy(w).to(torch.bfloat16)
    obj = {"w": torch.from_numpy(w), "b": bf, "ids": torch.arange(4),
           "nest": [torch.ones(2), (np.int8(3), "x")], "step": 7}
    framework.save(obj, str(tmp_path / "port.pd"), encryption_key=key)
    got = jfio.load(str(tmp_path / "port.pd"), encryption_key=key)
    np.testing.assert_array_equal(got["w"], w)
    assert got["b"].dtype == np.float32
    np.testing.assert_array_equal(got["b"], bf.float().numpy())
    np.testing.assert_array_equal(got["ids"], np.arange(4))
    assert isinstance(got["nest"][1], tuple) and got["step"] == 7

    jbf = paddle.to_tensor(w).astype("bfloat16")
    paddle.save({"w": paddle.to_tensor(w), "b": jbf, "l": [1, 2]},
                str(tmp_path / "jax.pd"), encryption_key=key)
    back = framework.load(str(tmp_path / "jax.pd"), encryption_key=key)
    assert isinstance(back["w"], np.ndarray)
    np.testing.assert_array_equal(back["w"], w)
    assert back["b"].dtype == torch.bfloat16
    want = np.asarray(jbf._data).view(np.uint16)
    np.testing.assert_array_equal(back["b"].view(torch.int16).numpy()
                                  .view(np.uint16), want)
    assert back["l"] == [1, 2]
    if key is not None:
        with pytest.raises(ValueError, match="encrypted"):
            framework.load(str(tmp_path / "jax.pd"))


def test_encrypted_bytes_cross_packages_and_tampering_raises(tmp_path):
    """The same ``PTPUENC1 | nonce | ct | tag`` format: each package
    decrypts the other's blob, and a flipped byte raises."""
    data = os.urandom(1000)
    nonce = b"n" * 16
    blob = tcrypto.encrypt_bytes(data, KEY, nonce=nonce)
    assert blob == jcrypto.encrypt_bytes(data, KEY, nonce=nonce)
    assert jcrypto.decrypt_bytes(blob, KEY) == data
    assert tcrypto.decrypt_bytes(jcrypto.encrypt_bytes(data, KEY),
                                 KEY) == data
    path = str(tmp_path / "state.pd")
    framework.save({"w": torch.ones(3)}, path, encryption_key=KEY)
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tcrypto.DecryptionError, match="authentication"):
        framework.load(path, encryption_key=KEY)


# -- jit.save / jit.load ----------------------------------------------------------
def test_jit_bundle_moves_weights_both_ways(tmp_path):
    """A port bundle of BERT-tiny with ``input_spec``: the port's
    ``jit.load`` runs it bit-equal to the live layer (positional and
    named feeds); the JAX ``jit.load`` finds no ``.jaxexport`` and
    returns the same arrays, and a JAX BERT-tiny holding them matches
    the port within the BERT parity tolerance (1e-4)."""
    from paddle_tpu.jit.to_static import load as jax_jit_load
    from paddle_tpu.models import bert as jbert
    batch = _batch(256)
    pm = BertForMaskedLM(bert_tiny(), device="cpu", seed=3).eval()
    path = str(tmp_path / "bert")
    jit.save(pm, path, input_spec=[a.shape for a in batch])
    assert not os.path.exists(path + ".jaxexport")
    with torch.no_grad():
        live = pm(*[torch.from_numpy(a) for a in batch])
    tl = jit.load(path, device="cpu")
    torch.testing.assert_close(tl(*batch), live, rtol=0, atol=0)
    feeds = {f"x{i}": a for i, a in enumerate(batch)}
    torch.testing.assert_close(tl(**feeds), live, rtol=0, atol=0)
    with pytest.raises(KeyError, match="unknown feed"):
        tl(ids=batch[0])
    with pytest.raises(TypeError, match="positionally"):
        tl(batch[0], x1=batch[1])

    arrays = jax_jit_load(path)
    assert isinstance(arrays, dict)
    sd = pm.state_dict()
    assert set(arrays) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(arrays[k], v.numpy(), err_msg=k)
    jm = jbert.BertForMaskedLM(jbert.bert_tiny())
    jm.set_state_dict(arrays)
    jm.eval()
    ref = jm(*[paddle.to_tensor(a) for a in batch])
    np.testing.assert_allclose(live.numpy(), np.asarray(ref._data),
                               atol=1e-4, rtol=0)


def test_jax_bundle_loads_as_arrays_and_config_raises(tmp_path):
    """A JAX bundle carries no recipe: the port's ``jit.load`` returns
    its arrays, and ``Config(path)`` raises the JAX package's
    weights-only error; a port bundle saved without ``input_spec``
    does the same."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.jit.to_static import save as jax_jit_save
    from paddle_tpu.static import InputSpec
    paddle.seed(1)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    path = str(tmp_path / "jax")
    jax_jit_save(jm, path, input_spec=[InputSpec((2, 8), "float32")])
    assert os.path.exists(path + ".jaxexport")
    arrays = jit.load(path, device="cpu")
    assert isinstance(arrays, dict)
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v._data))
    with pytest.raises(ValueError, match="weights-only save"):
        inference.create_predictor(inference.Config(path, device="cpu"))
    pm = BertForMaskedLM(bert_tiny(), device="cpu")
    jit.save(pm, str(tmp_path / "weights"))
    assert isinstance(jit.load(str(tmp_path / "weights"), device="cpu"),
                      dict)
    with pytest.raises(ValueError, match="weights-only save"):
        inference.create_predictor(
            inference.Config(str(tmp_path / "weights"), device="cpu"))
    with pytest.raises(ValueError, match="paddle_tpu_torch.models"):
        jit.save(torch.nn.Linear(2, 2), str(tmp_path / "x"),
                 input_spec=[(1, 2)])


@pytest.mark.parametrize("passes", ["f32", "int8", "int8+bf16"])
def test_config_path_predictor_equals_live(tmp_path, passes):
    """``save_optimized_model`` writes what the predictor runs (its
    ``QuantizedLinear``s, bf16 weights under ``enable_tpu_bf16``), and a
    ``Config(path)`` predictor gives the live one's outputs bit for bit,
    through its input handles too. The live layer stays float32."""
    batch = _batch(ALIGNED["vocab_size"])
    pm = BertForMaskedLM(bert_tiny(**ALIGNED), device="cpu", seed=2)
    cfg = inference.Config.from_layer(pm, [a.shape for a in batch])
    if "int8" in passes:
        cfg.enable_int8()
    if "bf16" in passes:
        cfg.enable_tpu_bf16()
    live = inference.create_predictor(cfg)
    ref = live.run(batch)[0]
    path = str(tmp_path / "opt")
    live.save_optimized_model(path)
    assert {p.dtype for p in pm.parameters()} == {torch.float32}
    loaded = inference.create_predictor(inference.Config(path, device="cpu"))
    assert loaded.get_input_names() == ["x0", "x1", "x2", "x3"]
    for name, a in zip(loaded.get_input_names(), batch):
        h = loaded.get_input_handle(name)
        assert h.shape() == a.shape
        h.copy_from_cpu(a)
    loaded.run()
    got = loaded.get_output_handle(loaded.get_output_names()[0])
    np.testing.assert_array_equal(got.copy_to_cpu(), ref)
    def n_quant(layer):
        return sum(type(m).__name__ == "QuantizedLinear"
                   for m in layer.modules())
    assert n_quant(loaded._layer) == n_quant(pm) == \
        (0 if passes == "f32" else 2 * 6 + 2)


def test_precision_warning_on_frozen_export(tmp_path):
    pm = BertForMaskedLM(bert_tiny(), device="cpu")
    jit.save(pm, str(tmp_path / "m"), input_spec=[(2, 64)])
    cfg = inference.Config(str(tmp_path / "m"), device="cpu")
    cfg.enable_tpu_bf16()
    with pytest.warns(UserWarning, match="already compiled"):
        inference.create_predictor(cfg)


# -- TrainStep save / resume --------------------------------------------------------
def test_trainstep_save_resume_bit_exact(tmp_path):
    """Three steps, ``save``, a fresh model and step that ``load`` the
    file, three more: the losses and parameters equal six uninterrupted
    steps from the same seed exactly (dropout on, so the generator's
    state is part of what resumes). The saved state is host numpy."""
    cfg = bert_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    batch = _batch(cfg.vocab_size)
    labels = np.random.default_rng(1).integers(5, 256, (2, 6))

    def fresh():
        m = BertForMaskedLM(cfg, device="cpu", seed=1)
        return TrainStep(
            m, lambda layer, i, t, a, p, y: layer.loss(layer(i, t, a, p), y),
            AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01),
            seed=5)

    a = fresh()
    ref = [float(a(*batch, labels)) for _ in range(6)]
    b = fresh()
    got = [float(b(*batch, labels)) for _ in range(3)]
    path = str(tmp_path / "ckpt.pd")
    b.save(path)
    state = b.state_dict()
    assert isinstance(next(iter(state["params"].values())), np.ndarray)
    assert state["rng_state"].dtype == np.uint8
    c = fresh()
    c.load(path)
    assert c.step_count == 3
    got += [float(c(*batch, labels)) for _ in range(3)]
    assert got == ref
    for (k, x), y in zip(a.layer.state_dict().items(),
                         c.layer.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)


# -- io: samplers and the DataLoader -------------------------------------------------
SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random-replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=7),
    "subset-random": lambda io, ds: io.SubsetRandomSampler([1, 4, 9, 2]),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        [0.1, 2.0, 0.5, 1.0, 3.0], 6),
    "batch-shuffle": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=3),
    "distributed": lambda io, ds: _epoch(io.DistributedBatchSampler(
        ds, 3, num_replicas=2, rank=1, shuffle=True)),
}


def _epoch(sampler, epoch=3):
    sampler.set_epoch(epoch)
    return sampler


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_sampler_orders_match_jax(kind):
    """After ``np.random.seed`` both packages draw the same index
    order (``DistributedBatchSampler`` from ``RandomState(epoch)``)."""
    data = np.arange(11)
    orders = []
    for io in (jio, tio):
        np.random.seed(7)
        orders.append(list(SAMPLERS[kind](io, io.Subset(data, range(11)))))
    assert orders[0] == orders[1]
    np.random.seed(7)
    split_j = [list(s.indices) for s in jio.random_split(data, [4, 7])]
    np.random.seed(7)
    split_t = [list(s.indices) for s in tio.random_split(data, [4, 7])]
    assert split_j == split_t


def _loader_batches(io, num_workers, **kw):
    x = np.arange(44, dtype=np.float32).reshape(22, 2)
    y = np.arange(22, dtype=np.int64) * 3
    np.random.seed(11)
    place = {"places": "cpu"} if io is tio else {}
    dl = io.DataLoader(io.TensorDataset([x, y]), batch_size=5, shuffle=True,
                       num_workers=num_workers, **place, **kw)
    it = iter(dl)
    batches = list(it)
    if io is tio:
        assert all(isinstance(t, torch.Tensor) for b in batches for t in b)
    return dl, it, [[np.asarray(t.numpy()) for t in b] for b in batches]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_batches_match_jax(num_workers):
    """Shuffled batches (the last one short) equal the JAX loader's,
    in order, exactly; the port's are torch tensors, and two workers
    go through the native queue. The JAX loader runs in-process: its
    batches do not depend on its worker count, and its forked workers
    start from a process that holds JAX's threads."""
    _, _, ref = _loader_batches(jio, 0)
    dl, it, got = _loader_batches(tio, num_workers)
    assert len(got) == len(ref) == len(dl) == 5
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    if num_workers:
        assert it.inner._native_q is not None


class _JaxStream(jio.IterableDataset):
    def __iter__(self):
        return iter({"v": np.float32(i), "i": i} for i in range(7))


class _PortStream(tio.IterableDataset):
    def __iter__(self):
        return iter({"v": np.float32(i), "i": i} for i in range(7))


def test_iterable_dataset_batches_match_jax():
    ref = list(jio.DataLoader(_JaxStream(), batch_size=3))
    got = list(tio.DataLoader(_PortStream(), batch_size=3, places="cpu"))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert set(g) == {"v", "i"}
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), r[k].numpy())
    last = list(tio.DataLoader(_PortStream(), batch_size=3, drop_last=True,
                               places="cpu"))
    assert len(last) == 2


def test_worker_exception_reaches_the_caller():
    """A worker's exception is raised in the consumer, through the
    ``multiprocessing`` queue when shared memory is off."""
    ds = tio.TensorDataset([np.arange(8, dtype=np.float32)])
    dl = tio.DataLoader(ds, batch_sampler=[[0, 1], [2, 99]], num_workers=2,
                        use_shared_memory=False, use_buffer_reader=False,
                        places="cpu")
    it = iter(dl)
    assert it.inner._native_q is None
    with pytest.raises(IndexError, match="99"):
        list(it)
