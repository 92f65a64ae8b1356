"""The port's ``incubate.moe`` against the JAX package's, on the CPU.

The router, both dispatch paths, the layer (stacked and heterogeneous
experts, a bf16 stream with the float32 router) and the reference-parity
``global_scatter`` / ``global_gather``; then one gloo world of four
ranks (``_torch_moe_workers``) runs the expert-parallel program at ep =
2 and 4 against the JAX explicit program (``shard_map`` + ``all_to_all``
on the virtual CPU devices), the MoE GPT's ``TrainStep`` on an ep mesh
against the JAX one, a sharded ``CheckpointManager`` resume, the chaos
hang drills and the refused meshes. Each docstring states its
tolerance.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.flags import flag_scope
from paddle_tpu_torch.distributed.spawn_mod import spawn
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.models import load_jax_weights
from paddle_tpu_torch.nn.layers.common import Linear

import _torch_moe_workers as W

CASES = ("ep_layer", "scatter_gather", "gpt_ep", "gpt_mp", "ckpt", "hang",
         "refused")
GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64, moe_experts=8,
               initializer_range=0.2)
GPT_B, GPT_S = 8, 16
LR = W.LR


@pytest.fixture(autouse=True)
def _moe_isolation():
    tmoe.reset_moe_stats()
    yield
    tmoe.reset_moe_stats()


def _jax_layer(cf, seed=11, top_k=2, D=W.D, E=W.E, H=W.H, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.incubate.moe import MoELayer as JaxMoE
    from paddle_tpu.incubate.moe import reset_moe_stats as jax_reset
    jax_reset()
    paddle.seed(seed)
    return JaxMoE(D, num_experts=E, d_hidden=H, top_k=top_k,
                  capacity_factor=cf, **kw)


def _arrays(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _jax_gpt():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_tiny
    paddle.seed(4)
    return JaxGPT(jax_tiny(**GPT_CFG))


def _gpt_batch():
    rng = np.random.default_rng(5)
    V = GPT_CFG["vocab_size"]
    return (rng.integers(0, V, (GPT_B, GPT_S)).astype(np.int32),
            rng.integers(0, V, (GPT_B, GPT_S)).astype(np.int32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_world")
    rng = np.random.RandomState(4)
    inputs = {
        "moe_weights": _arrays(_jax_layer(2.0)),
        "moe_x": rng.randn(W.B, W.S, W.D).astype(np.float32),
        "sg_x": rng.randn(4, 16, 3).astype(np.float32),
        "sg_w": rng.randn(4, 16, 3).astype(np.float32),
        "gpt_cfg": GPT_CFG, "gpt_weights": _arrays(_jax_gpt()),
        "gpt_batch": _gpt_batch()}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_moe_workers:run", args=(str(out), CASES), nprocs=4)
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


# -- routing ------------------------------------------------------------------
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_routing_decisions_equal_jax(top_k):
    """The same float32 logits (with ties in some rows) route to the
    same experts, positions and keeps exactly; gates, aux, z and the
    stats within 1e-6 relative (z: the logsumexp's last bit)."""
    import jax.numpy as jnp
    from paddle_tpu.incubate.moe import topk_routing as jax_routing
    rng = np.random.RandomState(top_k)
    logits = rng.randn(96, 8).astype(np.float32)
    logits[::7, 2] = logits[::7, 5]                   # exact ties
    C = tmoe.moe_capacity(96, 1.0, 8)
    ref = jax_routing(jnp.asarray(logits), top_k, C)
    got = tmoe.topk_routing(torch.from_numpy(logits), top_k, C)
    for f in ("idx", "pos", "keep"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("gates", "aux", "z", "stats"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    assert float(got.stats[0]) > 0.05                 # some pairs dropped


def test_top2_gating_and_capacity_match_jax():
    """``top2_gating``'s combine and dispatch tensors equal JAX's (1e-7)
    and its aux; a capacity of 2 holds at most 2 tokens an expert."""
    import jax.numpy as jnp
    from paddle_tpu.incubate.moe import top2_gating as jax_top2
    logits = np.random.RandomState(0).randn(32, 4).astype(np.float32)
    c, d, aux = tmoe.top2_gating(torch.from_numpy(logits), 16)
    jc, jd, jaux = jax_top2(jnp.asarray(logits), 16)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    skew = np.zeros((16, 2), np.float32)
    skew[:, 0] = 5.0
    _, d, _ = tmoe.top2_gating(torch.from_numpy(skew), 2)
    assert float(d[:, 0].sum()) <= 2


def test_flags_keep_the_jax_defaults():
    """The three MoE flags exist with the JAX package's defaults."""
    from paddle_tpu.core.flags import get_flag as jax_flag
    from paddle_tpu_torch.core.flags import get_flag
    for name in ("moe_dispatch", "moe_expert_parallel", "moe_a2a_chunks"):
        assert get_flag(name) == jax_flag(name), name
    assert tmoe.resolve_a2a_chunks(6, 4) == 3
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        tmoe.resolve_dispatch_mode("gather")


# -- the layer ----------------------------------------------------------------
def _jax_run(layer, x, mode, amp=False, router=True):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.flags import flag_scope as jax_flag_scope
    t = paddle.to_tensor(x)
    t.stop_gradient = False
    with jax_flag_scope("moe_dispatch", mode):
        with paddle.amp.auto_cast(level="O1", enable=amp):
            out = layer(t)
        loss = JF.mse_loss(out.astype("float32"), paddle.to_tensor(
            np.zeros(x.shape, np.float32)))
        if router:
            loss = loss + 0.01 * layer.aux_loss + 1e-3 * layer.z_loss
        loss.backward()
    return (np.asarray(out._data, np.float32), np.asarray(t.grad._data),
            {k: np.asarray(p.grad._data) for k, p in
             layer.named_parameters()}, np.asarray(layer.router_stats._data))


def _port_run(layer, x, mode, amp=False, router=True):
    from paddle_tpu_torch.amp import auto_cast
    t = torch.from_numpy(x).requires_grad_()
    with flag_scope("moe_dispatch", mode):
        with auto_cast(level="O1", enable=amp):
            out = layer(t)
    loss = out.float().square().mean()
    if router:
        loss = loss + 0.01 * layer.aux_loss + 1e-3 * layer.z_loss
    loss.backward()
    return (out.detach().float().numpy(), t.grad.numpy(),
            {k: p.grad.numpy() for k, p in layer.named_parameters()},
            layer.router_stats.numpy())


def _same_stats(got, ref):
    """Drop fraction, balance and loads exactly; the entropy (a mean of
    logs) within 1e-6 relative."""
    keep = [i for i in range(len(ref)) if i != 1]
    np.testing.assert_array_equal(got[keep], ref[keep])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)


def _port_layer(jax_layer, cf, top_k=2, **kw):
    return load_jax_weights(
        tmoe.MoELayer(W.D, num_experts=W.E, d_hidden=W.H, top_k=top_k,
                      capacity_factor=cf, device="cpu", **kw),
        _arrays(jax_layer))


@pytest.mark.parametrize("mode", ["sort", "einsum"])
@pytest.mark.parametrize("top_k,cf", [(1, 0.5), (2, 0.5), (2, 2.0)])
def test_layer_matches_jax_forward_and_gradients(mode, top_k, cf):
    """Converted weights, [2, 32, 16] tokens, 8 experts: the output and
    the gradients of ``mse + 0.01 aux + 1e-3 z`` (tokens, gate, every
    expert leaf) within 1e-5 of the largest, the stats as
    :func:`_same_stats`. cf 0.5
    drops pairs in both packages alike."""
    x = np.random.RandomState(1).randn(2, 32, W.D).astype(np.float32)
    jl = _jax_layer(cf, top_k=top_k)
    ref = _jax_run(jl, x, mode)
    got = _port_run(_port_layer(jl, cf, top_k), x, mode)
    for a, b in ((got[0], ref[0]), (got[1], ref[1])):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
    assert set(got[2]) == set(ref[2])
    for k, g in got[2].items():
        np.testing.assert_allclose(g, ref[2][k], err_msg=k,
                                   atol=1e-5 * np.abs(ref[2][k]).max())
    _same_stats(got[3], ref[3])
    if cf == 0.5:
        assert ref[3][0] > 0.1
    assert tmoe.MOE_STATS[f"{mode}_dispatches"] == 1


@pytest.mark.parametrize("top_k,cf", [(1, 0.5), (2, 2.0), (3, 1.0)])
def test_sort_and_einsum_agree(top_k, cf):
    """The port's two paths on one router: outputs within 1e-7, gate and
    expert gradients within 1e-7 of the largest, stats equal."""
    x = np.random.RandomState(2).randn(2, 32, W.D).astype(np.float32)
    jl = _jax_layer(cf, top_k=top_k)
    s = _port_run(_port_layer(jl, cf, top_k), x, "sort")
    e = _port_run(_port_layer(jl, cf, top_k), x, "einsum")
    np.testing.assert_allclose(s[0], e[0], atol=1e-7)
    for k in s[2]:
        np.testing.assert_allclose(s[2][k], e[2][k], err_msg=k,
                                   atol=1e-7 * np.abs(e[2][k]).max())
    np.testing.assert_array_equal(s[3], e[3])


def test_bf16_stream_keeps_the_f32_router():
    """Under O1 the tokens arrive in bf16 (cast here, as the embedding
    does): the router's logits are float32 and route as the float32
    tokens do, the FFN promotes to float32 and returns it (as the JAX
    einsum promotes); the output within 1e-5 of JAX's largest, the stats
    as :func:`_same_stats`."""
    from paddle_tpu_torch.amp import auto_cast
    x = np.random.RandomState(3).randn(2, 32, W.D).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jl = _jax_layer(1.0)
    tl = _port_layer(jl, 1.0)
    with auto_cast(level="O1"):
        logits = tl._router_logits(xb.reshape(-1, W.D))
        out = tl(xb)
    assert logits.dtype == torch.float32 and out.dtype == torch.float32
    xr = xb.float().numpy()                          # the bf16 values
    import paddle_tpu as paddle
    from paddle_tpu.core.flags import flag_scope as jax_flag_scope
    t = paddle.to_tensor(xr).astype("bfloat16")
    with jax_flag_scope("moe_dispatch", "sort"), \
            paddle.amp.auto_cast(level="O1"):
        jout = jl(t)
    assert str(jout._data.dtype) == "float32"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               atol=1e-5 * np.abs(out.detach().numpy()).max())
    _same_stats(tl.router_stats.numpy(), np.asarray(jl.router_stats._data))
    ref = _port_run(_port_layer(jl, 1.0), xr, "sort")
    np.testing.assert_array_equal(tl.router_stats.numpy(), ref[3])


def test_heterogeneous_experts_match_jax():
    """Four ``Linear(16, 16)`` experts in a list: converted weights give
    JAX's output and gradients within 1e-5 of the largest."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.incubate.moe import MoELayer as JaxMoE
    paddle.seed(9)
    jl = JaxMoE(W.D, [jnn.Linear(W.D, W.D) for _ in range(4)],
                capacity_factor=1.0)
    x = np.random.RandomState(5).randn(2, 16, W.D).astype(np.float32)
    ref = _jax_run(jl, x, "sort")
    tl = load_jax_weights(tmoe.MoELayer(
        W.D, [Linear(W.D, W.D, "cpu") for _ in range(4)],
        capacity_factor=1.0, device="cpu"), _arrays(jl))
    got = _port_run(tl, x, "sort")
    np.testing.assert_allclose(got[0], ref[0],
                               atol=1e-5 * np.abs(ref[0]).max())
    for k, g in got[2].items():
        np.testing.assert_allclose(g, ref[2][k], err_msg=k,
                                   atol=1e-5 * np.abs(ref[2][k]).max())


def test_router_side_outputs_and_telemetry():
    """``moe_vec`` is ``[aux, z, stats]``; the loads sum to 1; under
    ``FLAGS_monitor`` a forward publishes the JAX gauge and counter
    names, and ``publish_router_stats`` counts the layer."""
    from paddle_tpu_torch.monitor import scoped_registry
    tl = _port_layer(_jax_layer(2.0), 2.0)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 8, W.D)
                         .astype(np.float32))
    with scoped_registry() as reg, flag_scope("monitor", True), \
            torch.no_grad():
        tl(x)
        names = set(reg.names())
        assert tmoe.publish_router_stats(tl, reg) == 1
    v = tl.moe_vec.numpy()
    assert v.shape == (5 + W.E,)
    np.testing.assert_allclose(v[:2], [float(tl.aux_loss),
                                       float(tl.z_loss)], rtol=1e-6)
    np.testing.assert_array_equal(v[2:], tl.router_stats.numpy())
    np.testing.assert_allclose(v[5:].sum(), 1.0, atol=1e-5)
    assert {"moe_router_drop_pct", "moe_router_entropy",
            "moe_router_balance_pct", "moe_expert_load_share",
            "moe_dropped_tokens_total"} <= names


def test_non_uniform_counts_are_refused():
    """Variable per-expert counts would mis-route rows of the tiled
    exchange: NotImplementedError, as in JAX; counts that do not sum to
    the rows: ValueError."""
    x = torch.zeros(8, 2)
    with pytest.raises(NotImplementedError, match="non-uniform"):
        tmoe.global_scatter(x, np.array([1, 3, 2, 2]), None)
    with pytest.raises(NotImplementedError, match="non-uniform"):
        tmoe.global_gather(x, None, torch.tensor([2, 2, 3, 1]))
    with pytest.raises(ValueError, match="sums to"):
        tmoe.global_scatter(x, np.full(4, 3), None)


def test_incubate_softmax_mask_fuse_matches_jax():
    """The two softmax-mask compositions within 1e-6."""
    import paddle_tpu as paddle
    import paddle_tpu.incubate as jinc
    import paddle_tpu_torch.incubate as tinc
    rng = np.random.RandomState(7)
    a = rng.randn(2, 3, 5, 5).astype(np.float32)
    m = rng.randn(2, 1, 5, 5).astype(np.float32)
    np.testing.assert_allclose(
        tinc.softmax_mask_fuse(torch.from_numpy(a), torch.from_numpy(m)),
        np.asarray(jinc.softmax_mask_fuse(paddle.to_tensor(a),
                                          paddle.to_tensor(m))._data),
        atol=1e-6)
    np.testing.assert_allclose(
        tinc.softmax_mask_fuse_upper_triangle(torch.from_numpy(a)),
        np.asarray(jinc.softmax_mask_fuse_upper_triangle(
            paddle.to_tensor(a))._data), atol=1e-6)


# -- expert parallelism (one gloo world) -------------------------------------
def _jax_ep(n, mode, cf, router):
    """The JAX layer on an ep mesh of ``n`` virtual devices (its explicit
    program) or, with ``n`` None, meshless (the auto path)."""
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.spmd import make_mesh
    from paddle_tpu.incubate.moe import MOE_STATS as JSTATS
    if n is None:
        jenv.reset()
    else:
        jenv.set_mesh(make_mesh({"ep": n}))
    x = np.random.RandomState(4).randn(W.B, W.S, W.D).astype(np.float32)
    jl = _jax_layer(cf)
    res = _jax_run(jl, x, mode, router=router)
    if n is not None:
        assert JSTATS["ep_dispatches"] >= 1 and JSTATS["fallbacks"] == 0
    jenv.reset()
    return res, jl


def _check_ep(world, n, mode, cf, ref, jl, router):
    res = _case(world, "ep_layer")
    rows = W.B // n
    e_loc = W.E // n
    out, xg, grads, stats = ref
    for r in range(n):
        got = res[r][(n, mode, cf)]
        sl = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(got["out"], out[sl],
                                   atol=1e-5 * np.abs(out).max())
        np.testing.assert_allclose(got["x_grad"], xg[sl],
                                   atol=1e-5 * np.abs(xg).max())
        np.testing.assert_allclose(got["gate_grad"], grads["gate.weight"],
                                   atol=1e-5 * np.abs(
                                       grads["gate.weight"]).max())
        blk = slice(r * e_loc, (r + 1) * e_loc)
        for k in ("w1", "b2"):
            ref_g = grads[f"experts.{k}"]
            np.testing.assert_allclose(got[f"{k}_grad"], ref_g[blk],
                                       atol=1e-5 * np.abs(ref_g).max())
        assert got["stats_moe"]["ep_dispatches"] == 1
        assert got["stats_moe"]["fallbacks"] == 0
        if router:
            np.testing.assert_allclose(got["aux"], float(jl.aux_loss),
                                       rtol=1e-6)
            np.testing.assert_allclose(got["z"], float(jl.z_loss),
                                       rtol=1e-6)
            np.testing.assert_allclose(got["stats"], stats, atol=1e-6)


@pytest.mark.parametrize("n,mode", [(2, "sort"), (4, "sort"),
                                    (4, "einsum")])
def test_expert_parallel_matches_the_jax_explicit_program(world, n, mode):
    """ep = n ranks of 8 x 32 tokens' rows, capacity factor 0.5 (local
    capacity, pairs dropped), ``mse + 0.01 aux + 1e-3 z``: every rank's
    output rows, its tokens' and experts' gradients (over n: the global
    loss's) and the ep-mean gate gradient within 1e-5 of the largest;
    aux and z (the ep mean) within 1e-6; the stats within 1e-6. At ep =
    2 the layer holds every expert and takes its block; at ep = 4 it was
    cut to 2 experts by ``apply_param_shardings``."""
    ref, jl = _jax_ep(n, mode, 0.5, True)
    assert ref[3][0] > 0.1
    _check_ep(world, n, mode, 0.5, ref, jl, True)
    res = _case(world, "ep_layer")
    assert res[0][(n, mode, 0.5)]["w1_shape"][0] == (W.E if n == 2 else 2)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_matches_the_auto_path_at_ample_capacity(world, n):
    """Capacity factor E (nothing dropped, locally or globally): the ep
    program's outputs and data-loss gradients equal one process's auto
    path (meshless JAX) within 1e-5 of the largest."""
    ref, jl = _jax_ep(None, "sort", 8.0, False)
    assert ref[3][0] == 0.0
    _check_ep(world, n, "sort", 8.0, ref, jl, False)


def test_global_scatter_and_gather_over_ep(world):
    """Over ep = 4, 16 rows a rank: block d of rank s arrives at rank d
    as its block s (the JAX tiled ``all_to_all``), the gather returns
    every row home exactly, and ``sum(scatter(x) * w)``'s gradient is
    w sent back by the inverse exchange."""
    inputs, _ = world
    res = _case(world, "scatter_gather")
    x, w = inputs["sg_x"], inputs["sg_w"]
    for r in range(4):
        want = np.concatenate([x[s][4 * r:4 * (r + 1)] for s in range(4)])
        np.testing.assert_array_equal(res[r]["sent"], want)
        np.testing.assert_array_equal(res[r]["back"], x[r])
        grad = np.concatenate([w[d][4 * r:4 * (r + 1)] for d in range(4)])
        np.testing.assert_array_equal(res[r]["x_grad"], grad)


def _jax_gpt_steps(n, clipped=False):
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.spmd import make_mesh
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.optimizer import SGD as JaxSGD
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm as JaxClip
    mesh = make_mesh({"ep": n})
    jenv.set_mesh(mesh)
    jm = _jax_gpt()
    crit = JaxCrit()

    def loss_fn(layer, ids, labels):
        return crit(layer(ids), labels) + layer.moe_loss()
    opt = JaxSGD(learning_rate=W.SGD_LR, parameters=jm.parameters(),
                 grad_clip=JaxClip(W.CLIP)) if clipped else \
        JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    step = JaxTrainStep(jm, loss_fn, opt, mesh=mesh, data_spec=JP("ep"))
    batch = _gpt_batch()
    losses = [float(step(*batch)) for _ in range(2)]
    params = {k: np.asarray(v) for k, v in step.params.items()}
    jenv.reset()
    return losses, params


@pytest.mark.parametrize("n,clipped", [(2, False), (4, False),
                                       (4, True)])
def test_gpt_trainstep_on_ep_matches_the_jax_step(world, n, clipped):
    """``gpt_tiny`` with 8 experts in both layers (local capacity 8 of 32
    or 64 tokens: drops), ``crit + moe_loss``, ``data_spec=P("ep")``,
    under AdamW 1e-4, or SGD 0.1 under ``ClipGradByGlobalNorm(0.5)``
    (binding: the norm it reads, the expert blocks' squares summed over
    ep, is above 0.5): two steps' losses within 1e-5 and every gathered
    parameter within 1e-5 (the key bias, 0 gradient in exact arithmetic,
    within ``2 * lr * steps`` under AdamW) of the JAX ``TrainStep`` on
    the same ep mesh (the expert gradients divided by n, never reduced;
    the rest averaged over ep). Each rank keeps E/n experts."""
    jl, jparams = _jax_gpt_steps(n, clipped)
    res = [r[(n, clipped)] for r in _case(world, "gpt_ep")[:n]]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=0, atol=1e-5)
        assert r["ep_degree"] == n and r["w1_shape"][0] == W.E // n
        assert r["ep_dispatches"] == 2 * GPT_CFG["num_layers"]
        assert len(r["norms"]) == 2 * clipped
        assert all(x > W.CLIP for x in r["norms"])
        assert r["norms"] == res[0]["norms"]
    params = res[0]["params"]
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        got = params[k]
        if k.endswith("qkv_bias"):
            # the key bias has a 0 gradient in exact arithmetic: AdamW
            # moves it by its rounding noise, at most lr a step
            np.testing.assert_allclose(got[1], v[1], atol=2 * LR * 2)
            got, v = got[0::2], v[0::2]
        np.testing.assert_allclose(got, v, atol=1e-5, rtol=0, err_msg=k)


def test_sharded_checkpoint_manager_resumes_expert_blocks(world):
    """ep = 4: a ``CheckpointManager`` resume from the sharded save at
    step 4 (each rank's file its own expert blocks) continues the loss
    curve of six uninterrupted steps bit for bit."""
    res = _case(world, "ckpt")
    for r in res:
        assert r["first"] == r["ref"][:4]
        assert r["step"] == 4 and r["rest"] == r["ref"][4:]
    assert sum(f.startswith("shard_rank") for f in res[0]["files"]) == 4


def test_chaos_hang_on_the_expert_exchange_raises_structured(world):
    """A hung expert exchange under a 1 s budget raises
    ``CollectiveTimeoutError`` naming ``moe.all_to_all`` on ``ep``; a
    hung ``TrainStep`` dispatch of an ep model under 10 s names
    ``moe_step`` (the JAX drills' ops and axis)."""
    for r in _case(world, "hang"):
        assert r["healthy"] and r["ep_degree"] == 4
        assert r["layer"] == ("moe.all_to_all", "ep", 1.0)
        assert r["step"] == ("moe_step", "ep", 10.0)


def test_refused_fallbacks_and_meshes(world):
    """Where the JAX layer falls back to GSPMD on an ep mesh the port
    raises ``NotImplementedError`` with the JAX reason and counts no
    fallback; MoE over pp or sp raises too (sp naming the next part of
    ``distributed/``), and MoE over mp x ep runs."""
    for r in _case(world, "refused"):
        for reason in ("heterogeneous_experts", "custom_gate",
                       "indivisible", "flag_off"):
            assert r[reason] is not None and f"reason: {reason}" in \
                r[reason], reason
        for ax in ("pp", "sp"):
            assert r[ax] is not None and ax in r[ax], ax
        assert "part 3b" in r["sp"]
        assert r["mp"] is None
        assert r["fallbacks"] == 0


def _jax_sgd_steps(axes, cf=None, aux=True):
    """Two SGD steps of the JAX MoE GPT's ``TrainStep`` on a mesh of the
    virtual CPU devices (None: one device), and its parameters."""
    import jax
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.spmd import make_mesh
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.optimizer import SGD as JaxSGD
    mesh = None
    if axes is not None:
        mesh = make_mesh(axes, jax.devices()[:int(np.prod(list(
            axes.values())))])
        jenv.set_mesh(mesh)
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_tiny
    paddle.seed(4)
    jm = JaxGPT(jax_tiny(**GPT_CFG, **({} if cf is None else
                                       {"moe_capacity_factor": cf})))
    crit = JaxCrit()

    def loss_fn(layer, ids, labels):
        loss = crit(layer(ids), labels)
        return loss + layer.moe_loss() if aux else loss
    step = JaxTrainStep(jm, loss_fn, JaxSGD(learning_rate=W.SGD_LR,
                                            parameters=jm.parameters()),
                        mesh=mesh)
    losses = [float(step(*_gpt_batch())) for _ in range(2)]
    params = {k: np.asarray(v) for k, v in step.params.items()}
    jenv.reset()
    return losses, params


@pytest.mark.parametrize("name", ["mp", "ep_mp"])
def test_moe_gpt_over_mp_matches_jax(world, name):
    """The MoE GPT's ``TrainStep`` under SGD 0.1, two steps: at dp = 1 x
    mp = 2 with ``crit + moe_loss`` against the JAX GSPMD step on the
    ``{"mp": 2}`` mesh; at ep = 2 x mp = 2 (``data_spec=P("ep")``, no
    drops at capacity factor 8, ``crit`` alone) against the JAX auto path
    (one device) at the same capacity. Losses and every gathered
    parameter within 1e-5 in f32: the experts, replicated over mp, get
    the same gradient on every mp rank and no mp reduction. A rank keeps
    half the heads, and on ep x mp half the experts."""
    if name == "mp":
        jl, jparams = _jax_sgd_steps({"mp": 2})
        ranks, experts = 2, W.E
    else:
        jl, jparams = _jax_sgd_steps(None, cf=8.0, aux=False)
        ranks, experts = 4, W.E // 2
    res = [r[name] for r in _case(world, "gpt_mp")[:ranks]]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=0, atol=1e-5)
        assert r["w1"][0] == experts and r["qkv"][2] == 2
    params = res[0]["params"]
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


# -- the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_layer_on_card_matches_cpu(cuda, mode):
    """The layer at a GPT-2 345M-8E MoE layer's widths (D = 1024, 8
    experts of 4096, top-2, capacity factor 2) on 2048 tokens, f32 on
    the card against the CPU from the same weights: routes, drops and
    stats equal (but the entropy, 1e-6), output and gradients within
    1e-5 of their largest (full-f32 products: TF32 is off)."""
    D, E, H, T = 1024, 8, 4096, 2048
    g = torch.Generator().manual_seed(3)
    m = tmoe.MoELayer(D, num_experts=E, d_hidden=H, device="cpu")
    m.reset_parameters(g)
    x = torch.randn(2, T // 2, D, generator=g)
    res = []
    for dev in ("cpu", cuda):
        layer = tmoe.MoELayer(D, num_experts=E, d_hidden=H, device=dev)
        layer.load_state_dict(m.state_dict())
        xt = x.detach().to(dev).clone().requires_grad_()
        with flag_scope("moe_dispatch", mode):
            out = layer(xt)
        (out.square().mean() + 0.01 * layer.aux_loss
         + 1e-3 * layer.z_loss).backward()
        res.append((out.detach().cpu(), xt.grad.cpu(),
                    {k: p.grad.cpu() for k, p in layer.named_parameters()},
                    layer.router_stats.cpu().numpy()))
    (oc, xc, gc, sc), (og, xg, gg, sg) = res
    np.testing.assert_allclose(sg, sc, rtol=1e-6, atol=1e-7)
    for a, b in ((og, oc), (xg, xc), *((gg[k], gc[k]) for k in gc)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
