"""The port's ``recsys`` and ``models.dlrm`` against the JAX package's, on
the CPU.

The same numpy inputs from a seed go through both packages at
``dlrm_tiny`` sizes. Tolerances are the JAX tests' own
(``tests/test_recsys.py``): rows bit-equal before any update and within
``rtol=1e-6, atol=1e-7`` after; tier counters equal; DLRM losses within
1e-5 relative, dense parameters within 1e-5 and table rows within
``atol=5e-7`` over 3 steps (their adagrad sums, up to ~10, within the
rows' post-update ``rtol=1e-6``). One gloo world of two ranks
(``_torch_recsys_workers``) runs the ps-sharded table against the JAX
explicit ``shard_map`` program on a ps = 2 virtual mesh.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch import recsys as trec
from paddle_tpu_torch.core.flags import flag_scope
from paddle_tpu_torch.distributed.ps import SparseTable as TSparse
from paddle_tpu_torch.distributed.spawn_mod import spawn
from paddle_tpu_torch.models import load_jax_weights
from paddle_tpu_torch.models.dlrm import DLRM as TDLRM
from paddle_tpu_torch.models.dlrm import dlrm_tiny as t_tiny
from paddle_tpu_torch.monitor import scoped_registry
from paddle_tpu_torch.optimizer import Adam as TAdam
from paddle_tpu_torch.serving.resilience import ServerOverloaded
from paddle_tpu_torch.testing import chaos as tchaos

import _torch_recsys_workers as W

CASES = ("sharded", "dlrm", "refused", "restore")
AFTER = dict(rtol=1e-6, atol=1e-7)       # rows after an update
TABLE_ATOL = 5e-7                        # tables after 3 DLRM steps
WORLD_TABLE = (100, 16, 0.1, 7)          # V, D, lr, seed
DLRM_CFG = dict(num_sparse=3, vocab_sizes=256)


@pytest.fixture(autouse=True)
def _port_recsys_isolation():
    trec.reset()
    tchaos.reset()
    yield
    trec.reset()
    tchaos.reset()


@pytest.fixture
def jax_mesh_reset():
    """A JAX reference that runs under ``dist_env.set_mesh`` leaves no
    mesh behind."""
    from paddle_tpu.distributed import env as jenv
    yield
    jenv.set_mesh(None)


def _stream(seed, V, D, steps=6, n=40):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, size=n),
             rng.normal(size=(n, D)).astype(np.float32))
            for _ in range(steps)]


def _jax_dlrm(cfg_kw, tables=None, seed=1):
    import paddle_tpu as paddle
    from paddle_tpu.models.dlrm import DLRM, dlrm_tiny
    paddle.seed(seed)
    return DLRM(dlrm_tiny(**cfg_kw), tables=tables)


def _dense_arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


def _batches(cfg_kw, steps=3, B=32, seed=1):
    from paddle_tpu_torch.recsys import CriteoSynthetic
    cfg = t_tiny(**cfg_kw)
    gen = CriteoSynthetic(num_dense=cfg.num_dense, num_sparse=cfg.num_sparse,
                          vocab_sizes=cfg.vocab_sizes, batch_size=B,
                          seed=seed)
    return [gen.batch(i) for i in range(steps)]


def _jax_train(model, batches):
    import paddle_tpu as paddle
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=model.parameters())
    losses = []
    for dense, ids, labels in batches:
        loss = model.loss(dense, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _port_train(model, batches):
    opt = TAdam(learning_rate=1e-2, parameters=list(model.parameters()))
    losses = []
    for dense, ids, labels in batches:
        loss = model.loss(dense, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def _tables_close(got, want, what=""):
    """A table state against the JAX one: rows (``data``, ``hot_data``,
    ``backing.data``) within atol 5e-7, the adagrad sums (``g2``, up to
    ~10 after a few pushes) within rtol 1e-6 / atol 1e-7."""
    for k, v in _float_items(want).items():
        tol = AFTER if k.endswith("g2") else dict(rtol=0, atol=TABLE_ATOL)
        np.testing.assert_allclose(got[k], v, err_msg=f"{what}{k}", **tol)


def _float_items(state):
    return {k: np.asarray(v) for k, v in state.items()
            if np.asarray(v).dtype.kind == "f"}


# ---------------------------------------------------------------------------
# the loss, the generator, the dedup oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"weight": True}, {"pos_weight": True},
                                {"reduction": "sum", "weight": True,
                                 "pos_weight": True},
                                {"reduction": "none"}])
def test_bce_with_logits_matches_jax(kw):
    """``binary_cross_entropy_with_logits`` (f32 ``log_sigmoid`` form,
    weight, pos_weight, reduction) within 1e-6 relative of JAX's, on
    logits up to |z| ~ 15."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.functional import binary_cross_entropy_with_logits
    from paddle_tpu_torch.nn.functional import (
        binary_cross_entropy_with_logits as tbce)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=64) * 5).astype(np.float32)
    y = (rng.random(64) < 0.4).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    pw = np.full(64, 2.5, np.float32)
    jkw, tkw = {}, {}
    if kw.get("weight"):
        jkw["weight"], tkw["weight"] = paddle.to_tensor(w), torch.tensor(w)
    if kw.get("pos_weight"):
        jkw["pos_weight"] = paddle.to_tensor(pw)
        tkw["pos_weight"] = torch.tensor(pw)
    if "reduction" in kw:
        jkw["reduction"] = tkw["reduction"] = kw["reduction"]
    want = np.asarray(binary_cross_entropy_with_logits(
        paddle.to_tensor(z), paddle.to_tensor(y), **jkw)._data)
    got = tbce(torch.tensor(z), torch.tensor(y), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_criteo_synthetic_is_the_jax_stream():
    """Same seed, same batches and candidates, byte for byte."""
    from paddle_tpu.recsys import CriteoSynthetic as J
    from paddle_tpu_torch.recsys import CriteoSynthetic as T
    kw = dict(num_dense=5, num_sparse=3, vocab_sizes=[100, 2000, 50],
              alpha=1.1, batch_size=64, seed=9)
    j, t = J(**kw), T(**kw)
    for i in (0, 7):
        for a, b in zip(j.batch(i), t.batch(i)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.sample_ids(np.random.default_rng(3), 9),
                                  t.sample_ids(np.random.default_rng(3), 9))


def test_dedup_on_and_off_are_bit_equal_and_match_jax():
    """The dedup lookup and the per-id oracle give the same rows, the
    same post-push table and adagrad state, bit for bit; both equal the
    JAX table's rows before the push and its state after."""
    from paddle_tpu.core.flags import flag_scope as jflag
    from paddle_tpu.recsys import ShardedEmbeddingTable as JSh
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable as TSh
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, size=300)
    grads = rng.normal(size=(300, 8)).astype(np.float32)
    out = {}
    for dedup in (True, False):
        with flag_scope("recsys_dedup", dedup):
            t = TSh(50, 8, lr=0.1, seed=4, device="cpu")
            rows = t.pull(ids)
            t.push(ids, grads)
            out[dedup] = (rows, t.state_dict(), t.rows_fetched)
    for k in (0,):
        np.testing.assert_array_equal(out[True][k], out[False][k])
    for key in ("data", "g2"):
        np.testing.assert_array_equal(out[True][1][key], out[False][1][key])
    assert out[True][2] < ids.size == out[False][2]
    with jflag("recsys_dedup", True):
        j = JSh(50, 8, lr=0.1, seed=4)
        np.testing.assert_array_equal(j.pull(ids), out[True][0])
        j.push(ids, grads)
    for key in ("data", "g2"):
        np.testing.assert_allclose(out[True][1][key], j.state_dict()[key],
                                   **AFTER)


# ---------------------------------------------------------------------------
# the tables over one id stream
# ---------------------------------------------------------------------------

def _table_pair(kind, tmp_path):
    V, D = 64, 8
    if kind == "sparse":
        from paddle_tpu.distributed.ps import SparseTable as J
        return (J(V, D, optimizer="adagrad", lr=0.1, seed=5),
                TSparse(V, D, optimizer="adagrad", lr=0.1, seed=5), V, D)
    if kind == "ssd":
        from paddle_tpu.distributed.ps import SSDSparseTable as J
        from paddle_tpu_torch.distributed.ps import SSDSparseTable as T
        return (J(V, D, cache_rows=16, lr=0.1, seed=5,
                  path=str(tmp_path / "j.log")),
                T(V, D, cache_rows=16, lr=0.1, seed=5,
                  path=str(tmp_path / "t.log")), V, D)
    from paddle_tpu.recsys import ShardedEmbeddingTable as J
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable as T
    return J(V, D, lr=0.1, seed=5), T(V, D, lr=0.1, seed=5,
                                      device="cpu"), V, D


@pytest.mark.parametrize("kind", ["sparse", "ssd", "sharded"])
def test_table_matches_jax_over_one_id_stream(kind, tmp_path):
    """``SparseTable``, ``SSDSparseTable`` (a cache small enough to
    spill) and ``ShardedEmbeddingTable`` against the JAX class over one
    seeded stream of pulls and adagrad pushes: rows bit-equal before any
    update, within rtol 1e-6 / atol 1e-7 after, the final table too."""
    j, t, V, D = _table_pair(kind, tmp_path)
    np.testing.assert_array_equal(t.pull(np.arange(V)), j.pull(np.arange(V)))
    rng = np.random.default_rng(42)
    for step in range(20):
        ids = rng.integers(0, V, size=int(rng.integers(1, 48)))
        if step % 3 == 2:
            np.testing.assert_allclose(t.pull(ids), j.pull(ids), **AFTER)
        else:
            g = rng.normal(size=(ids.size, D)).astype(np.float32)
            j.push(ids, g)
            t.push(ids, g)
    np.testing.assert_allclose(t.pull(np.arange(V)), j.pull(np.arange(V)),
                               **AFTER)
    if kind == "ssd":
        assert t.evict_count == j.evict_count > 0
        t.close()
        j.close()


def _tier_pair(backing, tmp_path, **kw):
    from paddle_tpu.recsys import TieredEmbeddingTable as J
    from paddle_tpu_torch.recsys import TieredEmbeddingTable as T
    if backing == "sparse":
        from paddle_tpu.distributed.ps import SparseTable as JS
        kw_j = dict(backing=JS(kw["V"], kw["D"], lr=0.1, seed=2))
        kw_t = dict(backing=TSparse(kw["V"], kw["D"], lr=0.1, seed=2))
    else:
        kw_j = kw_t = dict(host_rows=24)
    args = dict(hot_rows=8, admit_after=2, lr=0.1, seed=2)
    return (J(kw["V"], kw["D"], name="j", **args, **kw_j),
            T(kw["V"], kw["D"], name="t", device="cpu", **args, **kw_t))


@pytest.mark.parametrize("backing", ["ssd", "sparse"])
def test_tiered_counters_and_rows_equal_jax(backing, tmp_path):
    """A ``TieredEmbeddingTable`` (8 hot slots, admission at 2 touches)
    over an SSD backing that spills, or a host ``SparseTable``, driven
    with the JAX one by one stream of pulls, device lookups and pushes:
    admissions, evictions, promotions, dirty write-backs, per-tier hits,
    residency and the backing's spills equal JAX's; rows as the other
    tables."""
    V, D = 400, 4
    j, t = _tier_pair(backing, tmp_path, V=V, D=D)
    rng = np.random.default_rng(2)
    for i in range(10):
        ids = np.concatenate([np.arange(6), rng.integers(0, V, size=30)])
        if i % 2:
            got = t.lookup(ids)
            assert isinstance(got, torch.Tensor)
            np.testing.assert_allclose(got.numpy(), np.asarray(j.lookup(ids)),
                                       **AFTER)
        else:
            np.testing.assert_allclose(t.pull(ids), j.pull(ids), **AFTER)
        g = rng.normal(size=(ids.size, D)).astype(np.float32)
        j.push(ids, g)
        t.push(ids, g)
    assert t.stats == j.stats
    assert t.stats["promotions"] and t.stats["demotions"]
    assert t.stats["evictions"] > t.stats["demotions"]
    assert t.tier_rows() == j.tier_rows()
    assert t.hit_rates() == j.hit_rates()
    assert t._dirty == j._dirty and list(t._lru) == list(j._lru)
    if backing == "ssd":
        assert t.backing.evict_count == j.backing.evict_count > 0
    np.testing.assert_allclose(t.pull(np.arange(V)), j.pull(np.arange(V)),
                               **AFTER)
    st, sj = t.state_dict(), j.state_dict()
    np.testing.assert_array_equal(st["hot_ids"], sj["hot_ids"])
    for k, v in _float_items(sj).items():
        np.testing.assert_allclose(st[k], v, **AFTER)
    t.close()
    j.close()


def test_tiered_hot_set_serves_from_the_device():
    """Once the working set is resident, ``lookup`` reads no backing
    tier and returns the hot tier's rows for the repeated ids."""
    from paddle_tpu_torch.recsys import TieredEmbeddingTable
    t = TieredEmbeddingTable(100, 4, hot_rows=16, admit_after=1, name="dev",
                             device="cpu")
    first = t.pull(np.array([1, 2, 3, 4]))
    pulls, hbm = t.backing.pull_count, t.stats["hbm_hits"]
    rows = t.lookup(np.array([1, 2, 3, 4, 4, 1]))
    assert t.backing.pull_count == pulls and t.stats["hbm_hits"] == hbm + 4
    np.testing.assert_array_equal(rows.numpy(), first[[0, 1, 2, 3, 3, 0]])
    t.close()


def test_tiered_state_dict_round_trip_and_cross_package(tmp_path):
    """A churned port table's ``state_dict`` restores into a port table
    and into a JAX table (same seed), each serving the same rows; and a
    JAX table's restores into the port."""
    from paddle_tpu.recsys import TieredEmbeddingTable as J
    from paddle_tpu_torch.recsys import TieredEmbeddingTable as T
    kw = dict(hot_rows=8, admit_after=1, lr=0.1, seed=3)
    src = T(300, 4, device="cpu", **kw)
    rng = np.random.default_rng(0)
    for _ in range(6):
        ids = rng.integers(0, 300, size=16)
        src.pull(ids)
        src.push(ids, rng.normal(size=(16, 4)).astype(np.float32))
    probe = np.arange(0, 300, 7)
    want = src.pull(probe)
    state = src.state_dict()
    for dst in (T(300, 4, device="cpu", **kw), J(300, 4, **kw)):
        dst.load_state_dict(state)
        assert dst.resident_hot_rows == src.resident_hot_rows
        np.testing.assert_allclose(dst.pull(probe), want, **AFTER)
        jstate = dst.state_dict()
        back = T(300, 4, device="cpu", **kw)
        back.load_state_dict(jstate)
        np.testing.assert_allclose(back.pull(probe), want, **AFTER)


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------

def _dlrm_tables(kind, both):
    """(jax tables, port tables) of ``kind``: per-slot tiered, or one
    shared table."""
    from paddle_tpu.recsys import ShardedEmbeddingTable as JSh
    from paddle_tpu.recsys import TieredEmbeddingTable as JT
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable as TSh
    from paddle_tpu_torch.recsys import TieredEmbeddingTable as TT
    D = t_tiny(**DLRM_CFG).embedding_dim
    if kind == "tiered":
        kw = dict(hot_rows=16, admit_after=1, lr=0.05)
        return ([JT(256, D, seed=f, name=f"j{f}", **kw) for f in range(3)],
                [TT(256, D, seed=f, name=f"t{f}", device="cpu", **kw)
                 for f in range(3)])
    return [JSh(256, D, lr=0.05, seed=3)], [TSh(256, D, lr=0.05, seed=3,
                                                device="cpu")]


@pytest.mark.parametrize("kind", ["tiered", "shared"])
def test_dlrm_trains_as_jax(kind):
    """Three Adam steps of ``dlrm_tiny`` (3 slots, vocab 256, B = 32)
    from the JAX model's dense weights: per-slot tiered tables, or ONE
    table shared by every slot, whose pushes must apply in the JAX
    tape's order (slots in reverse: each adagrad push changes the state
    the next reads). Losses within 1e-5 relative, dense parameters
    within 1e-5, tables as ``_tables_close``, tier counters equal."""
    jt, tt = _dlrm_tables(kind, True)
    jm = _jax_dlrm(DLRM_CFG, tables=jt)
    tm = load_jax_weights(TDLRM(t_tiny(**DLRM_CFG), tables=tt, device="cpu"),
                          _dense_arrays(jm))
    batches = _batches(DLRM_CFG)
    jl, tl = _jax_train(jm, batches), _port_train(tm, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js = _dense_arrays(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), js[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for j, t in zip(jt, tt):
        _tables_close(t.state_dict(), j.state_dict())
        if kind == "tiered":
            assert t.stats == j.stats
    if kind == "shared":
        assert tt[0].push_count == 3 * 3          # one push a slot a step
    assert all("table" not in k for k, _ in tm.named_parameters())
    assert tm.last_timings["lookup_s"] > 0 and tm.last_timings["mlp_s"] > 0


def test_dlrm_default_tables_and_no_grad_pushes_nothing():
    """Default per-slot host ``SparseTable``s are the JAX model's rows
    (seed + slot); a forward under ``torch.no_grad()`` records no node
    and pushes nothing; a loss's backward pushes once per slot."""
    jm = _jax_dlrm(DLRM_CFG)
    tm = load_jax_weights(TDLRM(t_tiny(**DLRM_CFG), device="cpu"),
                          _dense_arrays(jm))
    for j, t in zip(jm.tables, tm.tables):
        np.testing.assert_array_equal(t.data, j.data)
    dense, ids, labels = _batches(DLRM_CFG, steps=1)[0]
    with torch.no_grad():
        out = tm(dense, ids)
    assert out.shape == (32,) and not out.requires_grad
    assert all(t.push_count == 0 for t in tm.tables)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm(dense, ids)._data),
                               rtol=1e-5, atol=1e-6)
    tm.loss(dense, ids, labels).backward()
    assert all(t.push_count == 1 for t in tm.tables)
    with pytest.raises(ValueError, match="ids must be"):
        tm(dense, ids[:, :2])


def test_distributed_embedding_pushes_through_its_anchor():
    """``DistributedEmbedding``'s output needs a gradient although no
    input does (the anchor), its backward pushes the JAX layer's update
    into the table, and ``torch.no_grad()`` pushes nothing."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.ps import DistributedEmbedding as JDE
    from paddle_tpu_torch.distributed.ps import DistributedEmbedding as TDE
    ids = np.array([[1, 2, 2], [5, 1, 0]])
    j, t = JDE(16, 4, lr=0.1), TDE(16, 4, lr=0.1, device="cpu")
    np.testing.assert_array_equal(t.table.data, j.table.data)
    with torch.no_grad():
        t(ids)
    assert t.table.push_count == 0
    out = t(torch.tensor(ids))
    assert out.requires_grad and out.shape == (2, 3, 4)
    (out * out).sum().backward()
    jo = j(paddle.to_tensor(ids))
    (jo * jo).sum().backward()
    assert t.table.push_count == j.table.push_count == 1
    np.testing.assert_allclose(t.table.data, j.table.data, **AFTER)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _engines(cfg_kw=DLRM_CFG):
    """A JAX and a port DLRM over per-slot tiered tables, same weights."""
    from paddle_tpu.recsys import TieredEmbeddingTable as JT
    from paddle_tpu_torch.recsys import TieredEmbeddingTable as TT
    cfg = t_tiny(**cfg_kw)
    kw = dict(hot_rows=32, admit_after=1)
    jm = _jax_dlrm(cfg_kw, tables=[JT(256, cfg.embedding_dim, seed=f,
                                      name=f"j{f}", **kw)
                                   for f in range(cfg.num_sparse)])
    tm = load_jax_weights(
        TDLRM(cfg, tables=[TT(256, cfg.embedding_dim, seed=f, name=f"t{f}",
                              device="cpu", **kw)
                           for f in range(cfg.num_sparse)], device="cpu"),
        _dense_arrays(jm))
    return jm, tm, cfg


def _requests(cfg, n, seed, K=5, deadlines=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append((rng.normal(size=cfg.num_dense).astype(np.float32),
                    rng.integers(0, 256, size=(K, cfg.num_sparse)),
                    None if deadlines is None else deadlines[i]))
    return out


def _drive(pkg, model, reqs, config_kw, clock=None, steps=None):
    if pkg == "jax":
        from paddle_tpu.recsys import (RecsysEngine, RecsysRequest,
                                       RecsysServingConfig)
        from paddle_tpu.serving.resilience import ServerOverloaded as Over
    else:
        from paddle_tpu_torch.recsys import (RecsysEngine, RecsysRequest,
                                             RecsysServingConfig)
        Over = ServerOverloaded
    kw = {"clock": clock} if clock is not None else {}
    eng = RecsysEngine(model, RecsysServingConfig(**config_kw), **kw)
    states, refused = [], []
    for dense, ids, dl in reqs:
        try:
            states.append(eng.submit(RecsysRequest(dense, ids,
                                                   deadline_s=dl)))
        except Over as e:
            refused.append(e.reason)
    (eng.run() if steps is None else steps(eng))
    return eng, states, refused


@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest"])
def test_engine_outcomes_deadlines_and_policies_equal_jax(policy):
    """Eight requests into a queue of 6 under ``policy``, one with a
    blown deadline: per-request outcomes, refusals, the engine's stats,
    scores (within 1e-5) and rank orders equal the JAX engine's; the
    expired request fetched no row."""
    jm, tm, cfg = _engines()
    deadlines = [None, 60.0, None, -0.001, None, 60.0, None, None]
    reqs = _requests(cfg, 8, seed=0, deadlines=deadlines)
    conf = dict(max_batch=3, max_queue=6, queue_policy=policy)
    with scoped_registry() as reg:
        te, ts, tr = _drive("torch", tm, reqs, conf)
        assert reg.get("recsys_requests_total").value(
            event="completed") == te.stats["completed"]
        assert reg.get("recsys_lookup_seconds").count() > 0
    je, js, jr = _drive("jax", jm, reqs, conf)
    assert tr == jr
    assert [s.outcome for s in ts] == [s.outcome for s in js]
    assert te.stats == je.stats
    assert te.stats["expired"] == 1
    for a, b in zip(ts, js):
        if b.result is not None:
            np.testing.assert_allclose(a.result.scores, b.result.scores,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(a.result.order, b.result.order)
    s = te.metrics_summary()
    assert s["requests_completed"] == je.metrics_summary()[
        "requests_completed"] and s["candidates_per_sec"] > 0
    assert all(t.pull_count == j.pull_count
               for t, j in zip(tm.tables, jm.tables))


def test_engine_overload_hysteresis_equals_jax():
    """A fake clock trips the queue-delay detector after one step; a
    submit is refused with ``overload``; draining and an idle submit
    recover it, as in the JAX engine."""
    jm, tm, cfg = _engines()
    reqs = _requests(cfg, 3, seed=3)
    out = {}
    for pkg, model in (("jax", jm), ("torch", tm)):
        now = [0.0]

        def steps(eng, now=now):
            now[0] = 5.0
            eng.step()
        eng, states, refused = _drive(
            pkg, model, reqs[:2], dict(max_batch=1, overload_threshold_s=1.0,
                                       overload_alpha=1.0,
                                       overload_exit_frac=0.5),
            clock=lambda now=now: now[0], steps=steps)
        tripped = eng._overload.overloaded
        try:
            eng.submit(type(states[0].request)(reqs[2][0], reqs[2][1]))
            reason = None
        except Exception as e:
            reason = e.reason
        eng.run()
        st = eng.submit(type(states[0].request)(reqs[2][0], reqs[2][1]))
        recovered = not eng._overload.overloaded
        eng.run()
        out[pkg] = (tripped, reason, recovered, st.outcome, dict(eng.stats))
    assert out["torch"] == out["jax"]
    assert out["torch"][:4] == (True, "overload", True, "completed")


def test_engine_poisoned_request_fails_alone():
    """Out-of-range candidate ids fail their own request only (a range
    check in the sharded table), as in the JAX engine."""
    from paddle_tpu_torch.recsys import (RecsysEngine, RecsysRequest,
                                         RecsysServingConfig,
                                         ShardedEmbeddingTable)
    cfg = t_tiny(num_sparse=2, vocab_sizes=64)
    model = TDLRM(cfg, tables=[ShardedEmbeddingTable(64, cfg.embedding_dim,
                                                     device="cpu")],
                  device="cpu")
    eng = RecsysEngine(model, RecsysServingConfig(max_batch=8))
    rng = np.random.default_rng(7)
    good = [eng.submit(RecsysRequest(
        rng.normal(size=4).astype(np.float32),
        rng.integers(0, 64, size=(3, 2)))) for _ in range(3)]
    bad = eng.submit(RecsysRequest(rng.normal(size=4).astype(np.float32),
                                   np.array([[1, 64], [2, 3]])))
    eng.run()
    assert bad.outcome == "failed" and "64" in bad.failure
    assert all(s.outcome == "completed" for s in good)


# ---------------------------------------------------------------------------
# checkpoints, telemetry, registry
# ---------------------------------------------------------------------------

def test_save_tables_cross_package_round_trip(tmp_path):
    """``save_tables`` from JAX loads in the port and the reverse: a
    sharded and a tiered table, rows equal after the trip."""
    from paddle_tpu.recsys import ShardedEmbeddingTable as JSh
    from paddle_tpu.recsys import TieredEmbeddingTable as JT
    from paddle_tpu.recsys import load_tables as jload
    from paddle_tpu.recsys import save_tables as jsave
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable as TSh
    from paddle_tpu_torch.recsys import TieredEmbeddingTable as TT
    from paddle_tpu_torch.recsys import load_tables, save_tables
    ids = np.arange(12)
    g = np.ones((12, 4), np.float32)
    kw = dict(hot_rows=8, admit_after=1, lr=0.1, seed=0)
    js, jt = JSh(40, 4, lr=0.1, seed=1), JT(400, 4, **kw)
    for t in (js, jt):
        t.pull(ids)
        t.push(ids, g)
    jsave(str(tmp_path / "j"), {"sh": js, "ti": jt})
    ts, tt = TSh(40, 4, lr=0.1, seed=9, device="cpu"), TT(400, 4,
                                                          device="cpu", **kw)
    assert load_tables(str(tmp_path / "j"), {"sh": ts, "ti": tt}) \
        .endswith("tables_1")
    np.testing.assert_array_equal(ts.pull(np.arange(40)), js.pull(
        np.arange(40)))
    np.testing.assert_array_equal(tt.pull(ids), jt.pull(ids))
    tt.push(ids, g)
    ts.push(ids, g)
    save_tables(str(tmp_path / "t"), {"sh": ts, "ti": tt})
    js2, jt2 = JSh(40, 4, lr=0.1, seed=5), JT(400, 4, **kw)
    assert jload(str(tmp_path / "t"), {"sh": js2, "ti": jt2}) is not None
    np.testing.assert_array_equal(js2.pull(np.arange(40)),
                                  ts.pull(np.arange(40)))
    np.testing.assert_array_equal(jt2.pull(ids), tt.pull(ids))


def test_torn_snapshot_falls_back(tmp_path):
    """A torn write racing the commit (chaos ``ckpt.write.torn``) is
    skipped: ``load_tables`` restores the previous valid snapshot."""
    from paddle_tpu_torch.recsys import (TieredEmbeddingTable, load_tables,
                                         save_tables)
    kw = dict(hot_rows=16, admit_after=1, lr=0.1, device="cpu")
    t = TieredEmbeddingTable(400, 8, seed=0, **kw)
    ids = np.arange(12)
    t.pull(ids)
    t.push(ids, np.ones((12, 8), np.float32))
    good = t.pull(ids).copy()
    save_tables(str(tmp_path), {"ck": t})
    t.push(ids, np.ones((12, 8), np.float32))
    with tchaos.chaos_scope("ckpt.write.torn@1"):
        save_tables(str(tmp_path), {"ck": t})
    fresh = TieredEmbeddingTable(400, 8, seed=9, **kw)
    path = load_tables(str(tmp_path), {"ck": fresh})
    assert path is not None and path.endswith("tables_1")
    np.testing.assert_allclose(fresh.pull(ids), good, **AFTER)
    assert load_tables(str(tmp_path / "none"), {"ck": fresh}) is None


def test_tier_metrics_and_table_census():
    """Tier counters publish as deltas; the table census counts the
    tensors a table still holds (0 once they are dropped), beside the
    sharded table's data and g2."""
    from paddle_tpu_torch.recsys import (ShardedEmbeddingTable,
                                         TieredEmbeddingTable)
    t = TieredEmbeddingTable(500, 8, hot_rows=4, admit_after=1, name="rpt",
                             device="cpu")
    sh = ShardedEmbeddingTable(30, 4, device="cpu")
    trec.register_table("rpt", t)
    trec.register_table("sh", sh)
    rng = np.random.default_rng(0)
    for _ in range(4):
        t.pull(rng.integers(0, 500, size=32))
    with scoped_registry() as reg:
        t.publish_tier_metrics()
        out = trec.publish_table_hbm()
        assert out == {"rpt": t.hbm_bytes(), "sh": 30 * 4 * 4 + 30 * 4}
        assert reg.get("recsys_table_hbm_bytes").value(table="rpt") > 0
        assert reg.get("recsys_tier_promotions_total").value(
            table="rpt") == t.stats["promotions"]
    with scoped_registry() as reg:
        t.publish_tier_metrics()
        c = reg.get("recsys_tier_promotions_total")
        assert c is None or c.value(table="rpt") == 0
    t._hot = t._hot_g2 = None
    with scoped_registry():
        assert trec.publish_table_hbm()["rpt"] == 0


def test_reset_closes_registered_tables():
    import os
    from paddle_tpu_torch.recsys import TieredEmbeddingTable
    t = TieredEmbeddingTable(100, 4, hot_rows=4, name="closing",
                             device="cpu")
    path = t.backing.path
    trec.register_table("closing", t)
    assert os.path.exists(path)
    trec.reset()
    assert not os.path.exists(path) and trec.tables() == {}


def test_tables_resolve_to_the_card_by_default():
    """Without ``device`` a table, ``DLRM`` and ``DistributedEmbedding``
    run on the card: without one they raise rather than use the host."""
    from paddle_tpu_torch.distributed.ps import DistributedEmbedding
    from paddle_tpu_torch.recsys import (ShardedEmbeddingTable,
                                         TieredEmbeddingTable)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for build in (lambda: ShardedEmbeddingTable(8, 4),
                  lambda: TieredEmbeddingTable(8, 4, hot_rows=2),
                  lambda: DistributedEmbedding(8, 4),
                  lambda: TDLRM(t_tiny())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# ---------------------------------------------------------------------------
# the ps = 2 gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("recsys_world")
    V, D, lr, seed = WORLD_TABLE
    restore = np.random.default_rng(11)
    jm = _jax_dlrm(DLRM_CFG)
    inputs = {"table": WORLD_TABLE, "stream": _stream(0, V, D),
              "dlrm_cfg": DLRM_CFG, "dlrm_weights": _dense_arrays(jm),
              "batches": _batches(DLRM_CFG),
              "restore_state": {
                  "data": restore.normal(size=(37, 4)).astype(np.float32),
                  "g2": restore.random(37).astype(np.float32)}}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_recsys_workers:run", args=(str(out), CASES), nprocs=W.PS)
    ranks = []
    for r in range(W.PS):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _case(world, name):
    res = [r[name] for r in world[1]]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


def _jax_ps_mesh():
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.spmd import make_mesh
    jenv.set_mesh(make_mesh({"ps": W.PS}))


def test_ps_sharded_table_matches_the_jax_explicit_program(world,
                                                           jax_mesh_reset):
    """ps = 2 ranks (processes) against the JAX ``shard_map`` program on a
    ps = 2 virtual mesh over one stream: each rank holds one block [1, R,
    D]; rows bit-equal before any update and within rtol 1e-6 / atol
    1e-7 after, equal on both ranks; the gathered state as
    ``_tables_close``;
    every lookup and update explicit, no fallback. A one-process port
    table from the same initial rows gives the same rows bit for bit."""
    from paddle_tpu.recsys import RECSYS_STATS as JSTATS
    from paddle_tpu.recsys import ShardedEmbeddingTable as JSh
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable as TSh
    inputs = world[0]
    res = _case(world, "sharded")
    V, D, lr, seed = inputs["table"]
    _jax_ps_mesh()
    j = JSh(V, D, lr=lr, seed=seed)
    local = TSh(V, D, lr=lr, seed=seed, device="cpu")
    local.load_state_dict({"data": res[0]["pulls"][0],
                           "g2": np.zeros(V, np.float32)})
    assert j.num_shards == W.PS
    want = [j.pull(np.arange(V))]
    one = [local.pull(np.arange(V))]
    for ids, g in inputs["stream"]:
        want.append(j.pull(ids))
        one.append(local.pull(ids))
        j.push(ids, g)
        local.push(ids, g)
    want.append(j.pull(np.arange(V)))
    one.append(local.pull(np.arange(V)))
    assert JSTATS["manual_lookups"] > 0 and JSTATS["fallbacks"] == 0
    for r in res:
        assert r["shards"] == W.PS and r["block"] == (1, V // W.PS, D)
        assert r["stats"]["manual_lookups"] == len(want)
        assert r["stats"]["manual_updates"] == len(inputs["stream"])
        assert r["stats"]["fallbacks"] == 0
        np.testing.assert_array_equal(r["pulls"][0], want[0])
        np.testing.assert_array_equal(r["pulls"][1], want[1])
        for got, w, o in zip(r["pulls"], want, one):
            np.testing.assert_allclose(got, w, **AFTER)
            np.testing.assert_array_equal(got, o)
        _tables_close(r["state"], j.state_dict())
        for k in ("data", "g2"):
            np.testing.assert_array_equal(r["state"][k], res[0]["state"][k])


def test_ps_dlrm_matches_jax_on_a_ps_mesh(world, jax_mesh_reset):
    """DLRM over ps = 2 sharded slots trained three Adam steps in both
    ranks against the JAX DLRM over ``ShardedEmbeddingTable``s on a ps =
    2 virtual mesh: losses within 1e-5 relative, dense parameters within
    1e-5, tables as ``_tables_close``, both ranks equal."""
    from paddle_tpu.recsys import ShardedEmbeddingTable as JSh
    inputs = world[0]
    res = _case(world, "dlrm")
    _jax_ps_mesh()
    cfg = t_tiny(**DLRM_CFG)
    jt = [JSh(v, cfg.embedding_dim, lr=0.05, seed=f)
          for f, v in enumerate(cfg.vocab_list())]
    jm = _jax_dlrm(DLRM_CFG, tables=jt)
    jl = _jax_train(jm, inputs["batches"])
    js = _dense_arrays(jm)
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        for k, v in r["dense"].items():
            np.testing.assert_allclose(v, js[k], rtol=1e-5, atol=1e-5)
        for got, j in zip(r["tables"], jt):
            _tables_close(got, j.state_dict())
    assert res[0]["losses"] == res[1]["losses"]


def test_ps_auto_path_is_refused(world):
    """``FLAGS_recsys_sharded_lookup`` off on a ps mesh selects the JAX
    GSPMD auto path, which has no counterpart when ranks are processes:
    the port raises ``NotImplementedError`` on a lookup and on a push,
    and counts no fallback."""
    for r in _case(world, "refused"):
        for what in ("pull", "push"):
            assert r[what] is not None and "auto path" in r[what], r
        assert r["fallbacks"] == 0


def test_ps_checkpoint_moves_across_layouts(world):
    """A global-row-order state loads into ps = 2 ranks and reads back
    bit-equal (rows and g2), and a ps = 2 table's gathered state loads
    into a one-process port table and a JAX table."""
    from paddle_tpu.recsys import ShardedEmbeddingTable as JSh
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable as TSh
    state = world[0]["restore_state"]
    for r in _case(world, "restore"):
        np.testing.assert_array_equal(r["rows"], state["data"])
        for k in ("data", "g2"):
            np.testing.assert_array_equal(r["state"][k], state[k])
    gathered = _case(world, "sharded")[0]["state"]
    V, D = gathered["data"].shape
    for t in (TSh(V, D, seed=5, device="cpu"), JSh(V, D, seed=5)):
        t.load_state_dict(gathered)
        np.testing.assert_array_equal(t.pull(np.arange(V)), gathered["data"])
        np.testing.assert_array_equal(t.state_dict()["g2"], gathered["g2"])


def test_refusal_without_a_mesh_is_local():
    """Without a ps mesh the kill switch changes nothing: the table runs
    its local mode, as JAX's does."""
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable
    with flag_scope("recsys_sharded_lookup", False):
        t = ShardedEmbeddingTable(16, 4, device="cpu")
        t.push([1], np.ones((1, 4), np.float32))
        assert t.pull([1]).shape == (1, 4)
    assert trec.RECSYS_STATS["auto_lookups"] == 1
    with pytest.raises(NotImplementedError, match="auto path"):
        trec.note_recsys_fallback("flag_off")
