"""The port's sequence parallelism against the JAX package, on a CPU gloo
world of four ranks.

One world serves the file (``_torch_p2b_workers``): ring and Ulysses
attention over sp = 4 give each rank its shard of what the JAX
``ring_attention`` / ``ulysses_attention`` give under ``shard_map`` on a
4-device virtual mesh, forward and gradients (the JAX tests' 3e-5); a
sequence-parallel ``gpt_tiny`` at sp = 2 x mp = 2 and at sp = 4 trains
as the JAX GPT without a mesh (losses and gathered parameters within
1e-5, f32, dropout 0) and, at dropout 0.1, as the port's single-process
step (1e-5: the ring's merge order against one flash call); the same
GPT without ``sequence_parallel`` is refused on an sp mesh; the kernels'
row and column bases (plain versions of rows 1, 3 and 8) equal slices of
the whole launch bit for bit.

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_sequence_parallel.py``.
"""

import pickle

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn_mod import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.ops.kernels.dropout import dropout_plain
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain)
from paddle_tpu_torch.ops.ring_attention import block_attention, merge
from paddle_tpu_torch.optimizer import AdamW

N = 4
CASES = ("sp_attention", "sp_gpt")
SB, SS, SH, SD = 2, 32, 4, 16          # 8 positions a rank
GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, S = 4, 16
LAYOUTS = [(2, 2), (4, 1)]


def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    paddle.seed(0)
    return JaxGPT(jax_gpt_tiny(**GPT, initializer_range=0.2))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp_world")
    rng = np.random.RandomState(11)
    qkvg = tuple((rng.randn(SB, SS, SH, SD) * 0.5).astype(np.float32)
                 for _ in range(4))
    ids = rng.randint(0, GPT["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.randint(0, GPT["vocab_size"], (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.3).astype(np.float32)
    jm = _jax_model()
    inputs = {"sp_qkvg": qkvg,
              "gpt_cfg": dict(GPT, initializer_range=0.2),
              "gpt_weights": {k: np.asarray(v._data)
                              for k, v in jm.state_dict().items()},
              "gpt_batch": (ids, labels), "gpt_masked": (ids, labels, mask)}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn("_torch_p2b_workers:run", args=(str(out), CASES), nprocs=N)
    ranks = []
    for r in range(N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _case(world, name):
    res = [r[name] for r in world[1]]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


def _jax_sp(fn_name, causal, qkvg):
    """The JAX function under ``shard_map`` over 4 virtual devices: its
    output and the gradients of ``sum(o * g)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.env import shard_map
    from paddle_tpu.ops import ring_attention as jra
    fn = getattr(jra, fn_name)
    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))
    spec = P(None, "sp", None, None)
    kw = {} if fn_name == "ring_attention" else {"use_flash": False}

    def sharded(a, b, c):
        return shard_map(lambda x, y, z: fn(x, y, z, "sp", causal=causal,
                                            **kw),
                         mesh=mesh, in_specs=(spec, spec, spec),
                         out_specs=spec, check_vma=False)(a, b, c)
    q, k, v, g = (jnp.asarray(a) for a in qkvg)
    with jax.default_matmul_precision("highest"):
        o = sharded(q, k, v)
        grads = jax.grad(lambda a, b, c: jnp.sum(sharded(a, b, c) * g),
                         argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(o),) + tuple(np.asarray(t) for t in grads)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sp_attention_matches_jax_under_shard_map(world, name, causal):
    """Each rank's output shard and its shard's dq, dk, dv: the JAX
    function's on the same inputs, within 3e-5 (the JAX tests')."""
    inputs, _ = world
    want = _jax_sp(f"{name}_attention", causal, inputs["sp_qkvg"])
    n = SS // N
    for r, res in enumerate(_case(world, "sp_attention")):
        assert res["sp_rank"] == r
        sl = slice(r * n, (r + 1) * n)
        for got, w, what in zip(res[(name, causal)], want,
                                ("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(got, w[:, sl], atol=3e-5, rtol=3e-5,
                                       err_msg=f"{name} {what} rank {r}")


def test_block_attention_and_merge_match_jax():
    """``block_attention`` (the flash forward's plain version with its
    lse) and ``merge`` against the JAX functions, 2e-5; merging a
    sequence's two key halves gives the whole attention."""
    import jax.numpy as jnp

    from paddle_tpu.ops import ring_attention as jra
    rng = np.random.RandomState(5)
    q, k, v = ((rng.randn(2, 16, 4, 16) * 0.5).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for causal in (False, True):
        o, lse = block_attention(tq, tk, tv, causal)
        jo, jlse = jra.block_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                                   rtol=2e-5)
    halves = [block_attention(tq, tk[:, h], tv[:, h])
              for h in (slice(0, 8), slice(8, 16))]
    o, lse = merge(*halves[0], *halves[1])
    jo, jlse = jra._merge(*(jnp.asarray(t.numpy()) for t in halves[0]),
                          *(jnp.asarray(t.numpy()) for t in halves[1]))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    whole, wlse = block_attention(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), whole.numpy(), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), wlse.numpy(), atol=2e-5)


def _jax_steps(inputs):
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.jit.to_static import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCrit
    from paddle_tpu.optimizer import AdamW as JaxAdamW
    jm = _jax_model()
    jcrit = JaxCrit()
    jstep = JaxTrainStep(jm, lambda layer, i, t: jcrit(layer(i), t),
                         JaxAdamW(learning_rate=1e-4,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01))
    batch = [Tensor(a) for a in inputs["gpt_batch"]]
    return [float(jstep(*batch)) for _ in range(2)], jstep.params


@pytest.mark.parametrize("layout", LAYOUTS, ids=["sp2_mp2", "sp4"])
def test_sp_gpt_matches_the_jax_gpt_without_a_mesh(world, layout):
    """Sequence-parallel ``gpt_tiny`` (each rank 8 or 4 of 16 positions,
    ring attention over sp, the gradients summed over sp) against the
    JAX single-device step, f32, dropout 0: losses and every gathered
    parameter within 1e-5."""
    inputs, _ = world
    jl, jparams = _jax_steps(inputs)
    res = _case(world, "sp_gpt")
    for r in res:
        np.testing.assert_allclose(r[layout + ("jax",)]["losses"], jl,
                                   rtol=1e-5, atol=0)
    params = res[0][layout + ("jax",)]["params"]
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k], np.asarray(v), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS, ids=["sp2_mp2", "sp4"])
def test_gpt_without_sequence_parallel_is_refused_on_an_sp_mesh(world,
                                                                 layout):
    """A GPT without ``sequence_parallel`` would see only its shard of
    the sequence: a step over it on an sp mesh raises on every rank
    (the JAX step computes it whole, which the port does not)."""
    for r in _case(world, "sp_gpt"):
        msg = r[layout + ("refused",)]
        assert msg is not None and "sequence-parallel" in msg, msg


def _port_single(inputs, batch):
    model = load_jax_weights(GPTForPretraining(gpt_tiny(
        **inputs["gpt_cfg"], hidden_dropout_prob=0.1,
        attention_dropout_prob=0.1), device="cpu"), inputs["gpt_weights"])
    crit = GPTPretrainingCriterion()
    step = TrainStep(model, lambda layer, i, t, *m: crit(layer(i), t, *m),
                     AdamW(1e-4, parameters=model.parameters(),
                           weight_decay=0.01), seed=0)
    losses = [float(step(*batch)) for _ in range(2)]
    return losses, step.state_dict()["params"]


@pytest.mark.parametrize("tag", ["dropout", "masked"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=["sp2_mp2", "sp4"])
def test_sp_gpt_dropout_draws_the_single_process_masks(world, layout, tag):
    """At dropout 0.1 (embedding, residual branches, attention) every sp
    rank draws its positions' slice of the single-process masks (the
    kernels' sequence bases): losses and parameters within 1e-5 of the
    port's single-process step; with a loss mask the global masked
    mean."""
    inputs, _ = world
    batch = inputs["gpt_batch"] if tag == "dropout" else inputs["gpt_masked"]
    sl, sparams = _port_single(inputs, [torch.from_numpy(a) for a in batch])
    res = _case(world, "sp_gpt")
    for r in res:
        np.testing.assert_allclose(r[layout + (tag,)]["losses"], sl,
                                   rtol=1e-5, atol=0)
    params = res[0][layout + (tag,)]["params"]
    for k, v in sparams.items():
        np.testing.assert_allclose(params[k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


def test_plain_row_and_column_bases_are_slices_of_the_whole():
    """Rows 1 and 3 (plain versions) with row and column bases, and row 8
    with a row stride, draw the whole launch's mask: the forward of a
    query-row slice, the backward's dq of it, the backward's dk/dv of a
    key-column slice (given the whole o and lse) and the dropout of a
    sequence shard equal the whole's slices bit for bit."""
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 32, 4, 16)
                                    .astype(np.float32)) for _ in range(4))
    rate, words = 0.2, (123, 456)
    o, lse = flash_attention_plain(q, k, v, False, None, True, rate, words)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, False, None,
                                           rate, words)
    r, c = slice(8, 16), slice(16, 24)
    o2, lse2 = flash_attention_plain(q[:, r], k, v, False, None, True, rate,
                                     words, row_base=8)
    dq2 = flash_attention_bwd_plain(q[:, r], k, v, o[:, r], lse[:, :, r],
                                    do[:, r], False, None, rate, words,
                                    row_base=8)[0]
    _, dk2, dv2 = flash_attention_bwd_plain(q, k[:, c], v[:, c], o, lse, do,
                                            False, None, rate, words,
                                            col_base=16)
    for got, want in ((o2, o[:, r]), (lse2, lse[:, :, r]), (dq2, dq[:, r]),
                      (dk2, dk[:, c]), (dv2, dv[:, c])):
        assert torch.equal(got, want)
    x = torch.from_numpy(rng.randn(3, 16, 8).astype(np.float32))
    whole = dropout_plain(x, rate, words)
    part = dropout_plain(x[:, 4:12].contiguous(), rate, words, base=4 * 8,
                         row_len=8 * 8, row_stride=16 * 8)
    assert torch.equal(part, whole[:, 4:12])
