"""The port's pipeline (``distributed/`` part 2a) against the JAX package,
on a CPU gloo world of four ranks.

One world serves the whole file (``_torch_pipe_workers``: every case in
one spawn, results pickled back). ``GPTForPretrainingPipe`` at gpt_tiny
widths x 4 layers, B = 4, S = 16, f32, on pp = 2 x mp = 2, pp = 4 and pp
= 2 x dp = 2 (ZeRO-1 over dp), through both loss styles and both
schedules, equals the JAX model without a mesh (its sequential path
over the same stacked parameters) for 3 AdamW steps with the clip; at
dropout 0.1 fill-drain and 1F1B give the same bits and the port's
single-process step's losses; ``build_gpt_pipe`` through
``PipelineParallel.train_batch`` logs the JAX engine's schedule per
stage; ZeRO over ``sharding`` beside mp and LocalSGD hold their JAX
references. The schedule functions, ``SegmentLayers`` and the
tuple-axis layout are compared in this process.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.meta_parallel import spmd_pipeline as tsp
from paddle_tpu_torch.distributed.spawn_mod import spawn

CFG = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
           max_position_embeddings=64, initializer_range=0.2)
B, S, M = 4, 16, 2
CASES = ("pipe_topology", "p2p", "gpt_pipe", "dropout", "eager",
         "zero_sharding", "localsgd", "pipe_watchdog")
LR, WD, CLIP = 1e-3, 0.01, 0.5
# losses relative, parameters absolute: the stages sum the same products
# per microbatch where one device sums over the whole batch (float32)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def _jax_cfg(**over):
    from paddle_tpu.models.gpt import gpt_tiny
    return gpt_tiny(**dict(CFG, **over))


def _jax_pipe():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretrainingPipe
    paddle.seed(0)
    return GPTForPretrainingPipe(_jax_cfg(), num_microbatches=M)


def _jax_dense():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining
    paddle.seed(0)
    return GPTForPretraining(_jax_cfg())


def _arrays(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _unstack(weights):
    """The pipe model's weights under ``GPTForPretraining``'s names."""
    out = {}
    for k, v in weights.items():
        if k.startswith("blocks.stacked__"):
            name = k[len("blocks.stacked__"):].replace("__", ".")
            for i in range(v.shape[0]):
                out[f"gpt.layers.{i}.{name}"] = v[i]
        else:
            out["gpt." + k] = v
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import build_gpt_pipe
    out = tmp_path_factory.mktemp("pipe_world")
    rng = np.random.RandomState(11)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    # rows 0-1 keep 28 positions, rows 2-3 keep 7: uneven over dp
    mask = np.zeros((B, S), np.float32)
    mask[0, :] = 1.0
    mask[1, 4:] = 1.0
    mask[2, 3:8] = 1.0
    mask[3, 9:11] = 1.0
    pipe = _arrays(_jax_pipe())
    paddle.seed(5)
    jpp = build_gpt_pipe(_jax_cfg(), num_stages=2, accumulate_steps=M)
    eager = {k: np.asarray(p._data) for k, p in
             jpp._layers.named_parameters()}
    local = [(rng.randint(0, CFG["vocab_size"], (8, S)).astype(np.int32),
              rng.randint(0, CFG["vocab_size"], (8, S)).astype(np.int32))
             for _ in range(8)]
    inputs = {"cfg": CFG, "M": M, "batch": (ids, labels, mask),
              "pipe_weights": pipe, "dense_weights": _unstack(pipe),
              "eager_weights": eager, "local_batches": local}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_pipe_workers:run", args=(str(out), CASES), nprocs=4)
    ranks = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _case(world, name):
    res = [r[name] for r in world[1]]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


@pytest.fixture(scope="module")
def jax_refs(world):
    """The JAX GPTForPretrainingPipe without a mesh under its TrainStep,
    AdamW + ClipGradByGlobalNorm(0.5), 3 steps, in both loss styles."""
    from paddle_tpu.jit.to_static import TrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion
    from paddle_tpu.optimizer import AdamW
    from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm
    inputs, _ = world
    out = {}
    for style in ("forward", "pretraining"):
        jm = _jax_pipe()
        crit = GPTPretrainingCriterion()
        if style == "forward":
            def loss_fn(layer, i, t, m):
                return crit(layer(i), t)
        else:
            def loss_fn(layer, i, t, m):
                return layer.pretraining_loss(i, t, m)
        step = TrainStep(jm, loss_fn, AdamW(
            learning_rate=LR, parameters=jm.parameters(), weight_decay=WD,
            grad_clip=ClipGradByGlobalNorm(CLIP)))
        losses = [float(step(*inputs["batch"])) for _ in range(3)]
        out[style] = (losses, {k: np.asarray(v)
                               for k, v in step.params.items()})
    return out


# -- single-process: the schedules, segmentation, layouts ----------------------
def test_schedule_functions_equal_jax():
    """schedule_slots, bubble_fraction, schedule_timetable and
    pipeline_comm_model are the JAX functions' values for S in 1..4, M
    in 1..8, both schedules; each stage's 1f1b op order follows the
    timetable and holds at most S - s microbatches in flight."""
    from paddle_tpu.distributed.meta_parallel import spmd_pipeline as jsp
    for sched in ("fill_drain", "1f1b"):
        for S_ in range(1, 5):
            for M_ in range(1, 9):
                assert tsp.schedule_slots(sched, S_, M_) == \
                    jsp.schedule_slots(sched, S_, M_)
                assert tsp.bubble_fraction(sched, S_, M_) == \
                    jsp.bubble_fraction(sched, S_, M_)
                a = tsp.schedule_timetable(sched, S_, M_)
                b = jsp.schedule_timetable(sched, S_, M_)
                for key in ("fwd", "bwd", "busy"):
                    np.testing.assert_array_equal(a[key], b[key])
                assert a["bubble_fraction"] == b["bubble_fraction"]
                assert tsp.pipeline_comm_model(sched, S_, M_, 1024) == \
                    jsp.pipeline_comm_model(sched, S_, M_, 1024)
                for s in range(S_):
                    ops = tsp.stage_ops(sched, S_, M_, s)
                    assert sorted(ops) == sorted(
                        [("F", m) for m in range(M_)]
                        + [("B", m) for m in range(M_)])
                    want = min(S_ - s, M_) if sched == "1f1b" else M_
                    assert tsp.max_in_flight(sched, S_, M_, s) == want


def test_schedule_resolution_matches_jax():
    """The flag beats the explicit schedule, which beats the strategy;
    spellings normalize as in JAX; an unknown name raises."""
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.distributed import fleet
    assert tsp.resolve_schedule() == "1f1b"
    assert tsp.resolve_schedule("F-then-B") == "fill_drain"
    with flag_scope("pipeline_schedule", "gpipe"):
        assert tsp.resolve_schedule("1F1B") == "fill_drain"
    strategy = fleet._strategy()
    strategy.pipeline_configs = {"schedule_mode": "FThenB"}
    try:
        assert tsp.resolve_schedule() == "fill_drain"
        assert tsp.resolve_schedule("1f1b") == "1f1b"
    finally:
        fleet.reset()
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tsp.resolve_schedule("zigzag")


def test_segment_layers_equal_jax():
    """Uniform bounds for 1..12 descs over 1..4 parts, and layer-name
    bounds over GPT's descriptions, are the JAX ones."""
    from paddle_tpu.distributed.meta_parallel.parallel_layers import \
        pp_layers as jpl
    from paddle_tpu.models.gpt import gpt_pipeline_descs as jdescs
    from paddle_tpu_torch.distributed.meta_parallel.parallel_layers import \
        pp_layers as tpl
    from paddle_tpu_torch.models import gpt_pipeline_descs, gpt_tiny
    for n in range(1, 13):
        for parts in range(1, min(n, 4) + 1):
            assert tpl.SegmentLayers([0] * n, parts).do_segment() == \
                jpl.SegmentLayers([0] * n, parts).do_segment()
    tdesc = gpt_pipeline_descs(gpt_tiny(**CFG), device="cpu")
    jdesc = jdescs(_jax_cfg())
    assert [repr(d) for d in tdesc] == [repr(d) for d in jdesc]
    for parts in (1, 2, 4):
        for method in ("uniform", "layer:GPTDecoderLayer"):
            assert tpl.SegmentLayers(tdesc, parts, method).do_segment() == \
                jpl.SegmentLayers(jdesc, parts, method).do_segment()


def test_tuple_axis_layout_equals_jax_and_gathers(world):
    """Each rank's block of a dimension sharded over ("dp", "sharding")
    is the JAX NamedSharding's slice for that device (the outer axis
    major); the world gathers the blocks back to the full tensor."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    jmesh = JMesh(devs, ("dp", "sharding"))
    idx = NamedSharding(jmesh, JP(("dp", "sharding"))).devices_indices_map(
        (8, 3))
    full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, got in enumerate(_case(world, "p2p")):
        np.testing.assert_array_equal(got["block"],
                                      full[idx[devs.reshape(-1)[r]]])
        np.testing.assert_array_equal(got["gathered"], full)
        assert got["route"] == "direct"
    got = _case(world, "p2p")[1]["got"]
    assert got == {t: [float(t)] * 3 for t in (9, 2, 5)}


def test_fleet_builds_pp_mp_and_sharding_mp(world):
    """fleet.init with pp=2 x mp=2 gives each rank its stage, pp group,
    neighbours and the mp group of its stage; sharding=2 x mp=2 builds;
    sp=2 x mp=2 builds with the JAX topology's sp groups."""
    res = _case(world, "pipe_topology")
    for r, got in enumerate(res):
        pm = got["pp_mp"]
        assert pm["coord"] == (0, r // 2, 0, 0, r % 2)
        assert pm["stage"] == r // 2 and pm["mode"] == "pipeline"
        assert pm["pp_group"] == [r % 2, 2 + r % 2]
        assert pm["mp_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert pm["prev"] == (None if r < 2 else r - 2)
        assert pm["next"] == (r + 2 if r < 2 else None)
        assert pm["p2p"] == [pm["pp_group"]] * 2
        assert pm["mp_sum"] == float(sum(pm["mp_group"]))
        assert got["sharding_mp"]["mode"] == "sharding"
        assert got["sp"] == {"sp_group": [r % 2, 2 + r % 2],
                             "sp_rank": r // 2, "sp_size": 2}


# -- GPT over the pipeline -----------------------------------------------------
def _check_params(params, want, atol=PARAM_ATOL, key_bias_atol=None):
    """Every parameter within ``atol``; with ``key_bias_atol`` the key
    bias (``qkv_bias[..., 1, :, :]``) within that instead: its gradient
    is 0 in exact arithmetic (a constant added to a row's every score),
    so each side holds reassociation noise of either sign, which Adam's
    first updates divide by its own magnitude (up to lr a step either
    way, as chip_smoke's phase 21 bounds it)."""
    assert set(params) == set(want)
    for k, v in want.items():
        d = np.abs(params[k] - v)
        if key_bias_atol is not None and k.endswith("qkv_bias"):
            assert float(d[..., 1, :, :].max()) <= key_bias_atol, k
            d = np.delete(d, 1, axis=-3)
        assert float(d.max()) <= atol, (k, float(d.max()))


@pytest.mark.parametrize("layout", ["pp2_mp2", "pp4", "pp2_dp2"])
@pytest.mark.parametrize("style,schedule", [
    ("forward", "fill_drain"), ("pretraining", "fill_drain"),
    ("pretraining", "1f1b")])
def test_gpt_pipe_matches_jax(world, jax_refs, layout, style, schedule):
    """Losses within 1e-5 relative and gathered parameters within 1e-5
    of the JAX model without a mesh, every rank the same losses; the
    stack holds L/pp layers a rank, each stage held at most its
    timetable's in-flight count; ZeRO-1's slots skip the pp dim."""
    res = [r[(layout, style, schedule)] for r in _case(world, "gpt_pipe")]
    jl, jp = jax_refs[style]
    pp = {"pp2_mp2": 2, "pp4": 4, "pp2_dp2": 2}[layout]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=LOSS_RTOL, atol=0)
        assert r["losses"] == res[0]["losses"]
        assert r["local_layers"][0] == CFG["num_layers"] // pp
        sched = schedule if style == "pretraining" else "fill_drain"
        assert r["in_flight"] == tsp.max_in_flight(sched, pp, M, r["stage"])
        if layout == "pp2_dp2":
            # w_in [L/pp, 32, 128]: ZeRO over dp cuts the first free dim
            assert r["slot"] == (CFG["num_layers"] // pp, 16, 128)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    _check_params(res[0]["params"], jp)


def _port_dense_dropout(inputs, steps=2):
    """The port's single-process GPTForPretraining step at dropout 0.1
    on the same weights (masked mean, no clip)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import AdamW
    model = load_jax_weights(GPTForPretraining(gpt_tiny(
        **CFG, hidden_dropout_prob=0.1, attention_dropout_prob=0.1),
        device="cpu"), inputs["dense_weights"])
    crit = GPTPretrainingCriterion()
    step = TrainStep(model, lambda layer, i, t, m: crit(layer(i), t, m),
                     AdamW(LR, parameters=model.parameters(),
                           weight_decay=WD), seed=0)
    losses = [float(step(*inputs["batch"])) for _ in range(steps)]
    return losses, {k: v.detach().numpy()
                    for k, v in model.state_dict().items()}


@pytest.mark.parametrize("layout", ["pp2_mp2", "pp4"])
def test_schedules_bit_equal_with_dropout(world, layout):
    """Dropout 0.1: fill-drain and 1F1B give bit-equal losses and
    parameters, within 1e-5 of the port's single-process step from the
    same seed (the same masks: every stage draws the single-process
    seed words of its layers at its microbatches' batch bases; the key
    bias within 2 * lr a step, see ``_check_params``); a 1F1B
    step's state loads into a fill-drain step bit for bit and its next
    loss is the 1F1B step's."""
    inputs = world[0]
    res = _case(world, "dropout")
    want, dense = _port_dense_dropout(inputs)
    for r in res:
        fd, ob = r[(layout, "fill_drain")], r[(layout, "1f1b")]
        assert fd["losses"] == ob["losses"]
        for k, v in fd["params"].items():
            np.testing.assert_array_equal(v, ob["params"][k], err_msg=k)
        np.testing.assert_allclose(ob["losses"], want, rtol=LOSS_RTOL,
                                   atol=0)
        assert ob["loaded_equal"] and ob["next_loaded"] == ob["next"]
    stacked = {}
    for k, v in dense.items():
        name = k[len("gpt."):]
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault("blocks.stacked__" + rest.replace(".", "__"),
                               {})[int(i)] = v
        else:
            stacked[name] = v
    stacked = {k: np.stack([v[i] for i in sorted(v)]) if isinstance(v, dict)
               else v for k, v in stacked.items()}
    _check_params(res[0][(layout, "1f1b")]["params"], stacked,
                  key_bias_atol=2 * LR * 2)
    nodrop = _case(world, "gpt_pipe")[0][(layout, "pretraining", "1f1b")]
    assert abs(res[0][(layout, "1f1b")]["losses"][0]
               - nodrop["losses"][0]) > 1e-3


def test_eager_pipeline_matches_the_jax_engine(world):
    """build_gpt_pipe at pp = 2 x mp = 2 through train_batch, 3 AdamW
    steps: each stage's schedule log is the JAX engine's log filtered to
    that stage, the tied embedding stays equal on the first and last
    stage after every step, and the losses and a following eval_batch's
    are the JAX engine's."""
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.models.gpt import build_gpt_pipe
    from paddle_tpu.optimizer import AdamW
    inputs, _ = world
    paddle.seed(5)
    jpp = build_gpt_pipe(_jax_cfg(), num_stages=2, accumulate_steps=M)
    opt = AdamW(learning_rate=LR, parameters=jpp._layers.parameters(),
                weight_decay=WD)
    ids, labels, _ = inputs["batch"]
    data = (Tensor(ids), Tensor(labels))
    jl, logs = [], []
    for _ in range(3):
        jl.append(float(jpp.train_batch(data, opt)))
        logs.append(list(jpp._schedule_log))
    j_eval = float(jpp.eval_batch(data))
    res = _case(world, "eager")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(r["eval"], j_eval, rtol=LOSS_RTOL)
        for got, want in zip(r["logs"], logs):
            assert got == [e for e in want if e[1] == r["stage"]]
    for first, last in ((0, 2), (1, 3)):
        for a, b in zip(res[first]["tables"], res[last]["tables"]):
            np.testing.assert_array_equal(a, b)
    assert any("stage_1" in n and "shared" in n for n in res[2]["names"])


def test_zero_over_sharding_beside_mp_matches_jax(world):
    """sharding = 2 x mp = 2, ZeRO-1 over sharding (w_in's slots (16,
    64): mp cuts the columns, ZeRO the rows), the masked batch split over
    sharding, the clip at 0.5: losses (1e-5 relative) and parameters
    (1e-5) of the JAX single-device TrainStep. The JAX step on a
    sharding x mp virtual mesh does not run under this jax (its
    compiled shardings disagree with its arguments), so the reference
    is its single-device step, the same function."""
    from paddle_tpu.jit.to_static import TrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion
    from paddle_tpu.optimizer import AdamW
    from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm
    inputs, _ = world
    jm = _jax_dense()
    crit = GPTPretrainingCriterion()
    step = TrainStep(jm, lambda layer, i, t, m: crit(layer(i), t, m),
                     AdamW(learning_rate=LR, parameters=jm.parameters(),
                           weight_decay=WD,
                           grad_clip=ClipGradByGlobalNorm(CLIP)))
    jl = [float(step(*inputs["batch"])) for _ in range(3)]
    res = _case(world, "zero_sharding")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=LOSS_RTOL, atol=0)
        assert r["mode"] == "ShardingParallel"
        assert r["w_in"] == (32, 64) and r["slot"] == (16, 64)
    _check_params(res[0]["params"], {k: np.asarray(v)
                                     for k, v in step.params.items()})


def test_localsgd_matches_sync_sgd_and_jax(world):
    """dp = 4: LocalSGD with k = 1 is synchronous SGD (losses 1e-6,
    parameters 1e-6); k = 4 and adaptive (k0 = 2), built by TrainStep
    from the strategy, give the JAX LocalSGDTrainStep's losses (1e-5
    relative) over 8 calls, its syncs and its adapted k."""
    import jax
    from jax.sharding import Mesh as JMesh
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        LocalSGDTrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion
    from paddle_tpu.optimizer import AdamW
    inputs, _ = world
    res = _case(world, "localsgd")
    for r in res:
        np.testing.assert_allclose(r["k1"], r["sync"], rtol=0, atol=1e-6)
        assert r["k1_params"] <= 1e-6
    crit = GPTPretrainingCriterion()
    mesh = JMesh(np.array(jax.devices()[:4]), ("dp",))
    for name, kw in (("k4", dict(k_steps=4)),
                     ("adaptive", dict(k_steps=2, adaptive=True))):
        jm = _jax_dense()
        step = LocalSGDTrainStep(
            jm, lambda layer, i, t: crit(layer(i), t),
            AdamW(learning_rate=LR, parameters=jm.parameters(),
                  weight_decay=WD), mesh, **kw)
        jl = [float(step(*b)) for b in inputs["local_batches"]]
        for r in res:
            got = r[name]
            assert got["type"] == "LocalSGDTrainStep"
            np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL,
                                       atol=0)
            st = step.stats()
            for key in ("localsgd_syncs", "local_steps", "k_steps",
                        "initial_k_steps", "num_replicas"):
                assert got["stats"][key] == st[key], key
    synced = [r["synced"] for r in res]
    for s in synced[1:]:
        for a, b in zip(s, synced[0]):
            np.testing.assert_array_equal(a, b)


def test_pipe_state_dict_names_and_layouts_are_jax():
    """GPTForPretrainingPipe's state dict is the JAX model's: the same
    names (``blocks.stacked__*``) and shapes, loaded by
    ``load_jax_weights`` unchanged; each stacked spec is ("pp", *the
    template's)."""
    from paddle_tpu_torch.models import (GPTForPretrainingPipe, gpt_tiny,
                                         load_jax_weights)
    jw = _arrays(_jax_pipe())
    model = GPTForPretrainingPipe(gpt_tiny(**CFG), device="cpu")
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: v.shape for k, v in jw.items()}
    load_jax_weights(model, jw)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jw[k], err_msg=k)
    qkv = model.blocks.stacked__attn__qkv_weight
    assert tuple(qkv.spec) == ("pp", None, None, "mp", None)
    per = model.blocks.layer_state_dict(2)
    assert torch.equal(per["attn.qkv_weight"], qkv[2])


def test_pipe_without_a_mesh_matches_the_dense_model():
    """No pp axis: the stack runs its layers in turn, so the pipe
    model's logits and pretraining loss are GPTForPretraining's on the
    unstacked weights (bit for bit), and ``load_from_layers`` restacks
    the dense model's blocks."""
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTForPretrainingPipe,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    jw = _arrays(_jax_pipe())
    pipe = load_jax_weights(GPTForPretrainingPipe(gpt_tiny(**CFG),
                                                  device="cpu"), jw)
    dense = load_jax_weights(GPTForPretraining(gpt_tiny(**CFG),
                                               device="cpu"), _unstack(jw))
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, 64, (2, 8)))
    labels = torch.from_numpy(rng.randint(0, 64, (2, 8)))
    assert torch.equal(pipe(ids), dense(ids))
    want = GPTPretrainingCriterion()(dense(ids), labels)
    assert torch.equal(pipe.pretraining_loss(ids, labels), want)
    other = GPTForPretrainingPipe(gpt_tiny(**CFG), device="cpu", seed=3)
    other.blocks.load_from_layers(list(dense.gpt.layers))
    for k, v in pipe.blocks.state_dict().items():
        assert torch.equal(other.blocks.state_dict()[k], v), k


def test_hung_pipeline_step_raises_under_the_watchdog(world, jax_refs):
    """FLAGS_collective_timeout_s with the chaos hang armed: the
    pipelined TrainStep raises CollectiveTimeoutError as a
    ``pipeline_step`` on the pp group, the step count stays, and the
    next call trains (the JAX step's first loss)."""
    for r in _case(world, "pipe_watchdog"):
        assert r["error"] == ("pipeline_step", "pp")
        assert r["steps"] == 0
        np.testing.assert_allclose(r["loss"], jax_refs["pretraining"][0][0],
                                   rtol=LOSS_RTOL)


def test_eager_pipeline_in_one_process_matches_the_jax_engine():
    """Without a pp topology one process builds and runs every stage, as
    the JAX controller does: the same JAX weights give its schedule log
    and losses over 2 train_batch calls (Adam, lr 1e-3), one table
    instance."""
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.models.gpt import build_gpt_pipe as jbuild
    from paddle_tpu.optimizer import Adam as JAdam
    from paddle_tpu_torch.models import build_gpt_pipe, gpt_tiny
    from paddle_tpu_torch.optimizer import Adam
    paddle.seed(9)
    jpp = jbuild(_jax_cfg(), num_stages=2, accumulate_steps=M)
    weights = {k: np.array(p._data) for k, p in
               jpp._layers.named_parameters()}
    pipe = build_gpt_pipe(gpt_tiny(**CFG), num_stages=2,
                          accumulate_steps=M, device="cpu")
    assert sorted(k for k, _ in pipe.named_parameters()) == sorted(weights)
    with torch.no_grad():
        for k, p in pipe.named_parameters():
            p.copy_(torch.from_numpy(weights[k]))
    rng = np.random.RandomState(4)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    jopt = JAdam(learning_rate=LR, parameters=jpp._layers.parameters())
    opt = Adam(LR, parameters=pipe.parameters())
    for _ in range(2):
        want = float(jpp.train_batch((Tensor(ids), Tensor(labels)), jopt))
        got = float(pipe.train_batch((torch.from_numpy(ids),
                                      torch.from_numpy(labels).long()), opt))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert pipe._schedule_log == jpp._schedule_log
