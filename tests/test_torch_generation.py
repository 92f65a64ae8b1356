"""The port's static-cache generation and beam search
(``paddle_tpu_torch.models.generation``, ``paddle_tpu_torch.nn.decode``)
against the JAX package on the CPU.

A ``gpt_tiny`` model from one numpy seed (the JAX model's weights carried
into the port by ``models.convert``; wide enough, at
``initializer_range`` 0.3, that greedy picks have clear margins) serves
both packages' ``generate``. Greedy tokens, eos padding and the
``max_position_embeddings`` refusal must be identical; the sampling
filter's top-k / top-p masks must be identical to those of the JAX
``_sample`` on the same logits (its draw is replaced by a recorder, so
its own filter code runs); the draws themselves come from different
generators, so only their range and their reproducibility per seed are
checked. The port's ``generate`` must give its own ``ServingEngine``'s
greedy tokens. Beam search runs the JAX test's table cell
(``tests/test_beam_search.py::ToyLM``) in both packages: ids, parents,
scores and lengths equal, and the brute-force optimum found.

Tolerances: tokens, ids, parents, lengths and masks exact; logits of
the static-cache forward and the K/V it writes within 2e-5 of the
largest magnitude of the JAX forward's (float32 sums in another order
through two 128-wide layers); beam scores within 1e-5 absolute (float32
log-softmax sums); the brute-force score within 1e-4 relative,
as the JAX test allows. The ``cuda`` cases hold ``generate`` on the
card (flash forward at position 0, paged decode over the buffers as
pages) against the CPU plain path: greedy tokens equal, logits within
1e-4 in float32; a bf16 model's attention over the float32 buffers runs
in float32 on both routes, its greedy tokens equal. Near top_p = 1 the filter masks are held to a float64
reference instead of to JAX's bits (see that test).

On the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_generation.py``.
JAX is imported inside the tests that use it, so that the ``cuda`` cases
also run on a card without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_generation.py``.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import (GPTForPretraining, generate, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.gpt import STATIC_BLOCK, GPTAttention
from paddle_tpu_torch.ops import kernels

WIDE = dict(hidden_size=128, num_heads=2, initializer_range=0.3)
CFG = dict(max_batch_slots=3, block_size=4, max_context_len=64,
           prefill_buckets=(8, 16), batch_buckets=(1, 2))


def _jax():
    """The JAX package's surfaces these tests hold the port to."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.core.tensor import no_grad
    from paddle_tpu.models import generation
    from paddle_tpu.models.gpt import GPTAttention
    from test_beam_search import ToyLM, _brute_force
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, paddle=paddle, nn=nn, no_grad=no_grad,
        generation=generation, GPTAttention=GPTAttention, ToyLM=ToyLM,
        brute_force=_brute_force)


@pytest.fixture(scope="module")
def models():
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    paddle = _jax().paddle
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**WIDE))
    jm.eval()
    named = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jm, load_jax_weights(GPTForPretraining(gpt_tiny(**WIDE),
                                                  device="cpu"), named)


def _prompts(B, S0, seed=0):
    return np.random.default_rng(seed).integers(2, 250, (B, S0)) \
        .astype(np.int32)


# -- generate --------------------------------------------------------------------
@pytest.mark.parametrize("B,S0,new", [(2, 8, 6), (3, 5, 12), (1, 16, 1)])
def test_greedy_generate_matches_jax(models, B, S0, new):
    jm, tm = models
    prompt = _prompts(B, S0, seed=S0)
    want = jm.generate(prompt, max_new_tokens=new,
                       decode_strategy="greedy_search").numpy()
    got = tm.generate(prompt, max_new_tokens=new,
                      decode_strategy="greedy_search")
    assert got.dtype == torch.int32 and got.shape == (B, S0 + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_padding_matches_jax(models):
    jm, tm = models
    prompt = _prompts(3, 6, seed=1)
    greedy = jm.generate(prompt, max_new_tokens=9,
                         decode_strategy="greedy_search").numpy()
    # the third token row 0 generates ends it; the rest is padding
    eos = int(greedy[0, 8])
    kw = dict(max_new_tokens=9, decode_strategy="greedy_search",
              eos_token_id=eos, pad_token_id=1)
    want = jm.generate(prompt, **kw).numpy()
    got = tm.generate(prompt, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 8] == eos and (got[0, 9:] == 1).all()


def test_generate_refuses_past_the_position_table(models):
    jm, tm = models
    prompt = _prompts(1, 100)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="max_position_embeddings"):
            m.generate(prompt, max_new_tokens=29,
                       decode_strategy="greedy_search")
    with pytest.raises(ValueError, match="decode_strategy"):
        generate(tm, prompt[:, :4], decode_strategy="beam_search")


def test_greedy_generate_is_the_full_forward_rollout(models):
    _, tm = models
    prompt = _prompts(2, 8)
    out = tm.generate(prompt, max_new_tokens=6,
                      decode_strategy="greedy_search").numpy()
    ids = prompt.astype(np.int64)
    with torch.no_grad():
        for t in range(6):
            nxt = tm(torch.from_numpy(ids))[:, -1].argmax(-1).numpy()
            np.testing.assert_array_equal(out[:, 8 + t], nxt)
            ids = np.concatenate([ids, nxt[:, None]], axis=1)


def test_static_cache_forward_matches_jax(models):
    """A prefill at position 0 and two one-token steps over the static
    buffers: the port's logits against the JAX model's, the buffers'
    written slots equal, and ``cache_pos`` required."""
    jm, tm = models
    J = _jax()
    paddle, jnp = J.paddle, J.jnp
    cfg = tm.cfg
    B, S0, L = 2, 7, 16
    H, D = cfg.num_heads, cfg.head_dim
    ids = _prompts(B, S0 + 2, seed=3)
    jc = [J.GPTAttention.StaticCache(
        paddle.Tensor(jnp.zeros((B, L, H, D), jnp.float32)),
        paddle.Tensor(jnp.zeros((B, L, H, D), jnp.float32)))
        for _ in range(cfg.num_layers)]
    tc = [GPTAttention.StaticCache(torch.zeros(B, L, H, D),
                                   torch.zeros(B, L, H, D))
          for _ in range(cfg.num_layers)]
    chunks = [(ids[:, :S0], 0), (ids[:, S0:S0 + 1], S0),
              (ids[:, S0 + 1:S0 + 2], S0 + 1)]
    for chunk, pos in chunks:
        with J.no_grad():
            jl, jc = jm(paddle.to_tensor(chunk), caches=jc,
                        cache_pos=paddle.to_tensor(np.int32(pos)))
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(chunk.astype(np.int64)),
                        caches=tc, cache_pos=pos)
        want = jl.numpy()
        np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    n = S0 + 2
    for j, t in zip(jc, tc):
        want = np.asarray(j.k._data)[:, :n]
        np.testing.assert_allclose(t.k[:, :n].numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="cache_pos"):
        tm(torch.from_numpy(ids[:, :2].astype(np.int64)), caches=tc)


FILTERS = [dict(temperature=0.8, top_k=20, top_p=1.0),
           dict(temperature=1.0, top_k=0, top_p=0.9),
           dict(temperature=0.7, top_k=50, top_p=0.8),
           dict(temperature=1.3, top_k=300, top_p=0.5)]


@pytest.mark.parametrize("kw", FILTERS)
def test_sampling_filter_masks_match_jax(monkeypatch, kw):
    """The JAX ``_sample`` runs on the same logits with its draw replaced
    by a recorder of the filtered logits it would draw from."""
    J = _jax()
    logits = np.random.default_rng(7).normal(size=(5, 256)) \
        .astype(np.float32) * 3.0
    seen = []

    def record(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return J.jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(J.jax.random, "categorical", record)
    J.generation._sample(J.jnp.asarray(logits), J.jax.random.key(0),
                         "sampling", kw["temperature"], kw["top_k"],
                         kw["top_p"])
    want = seen[0]
    got = tgen.filter_logits(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_array_equal(got <= -1e30, want <= -1e30)
    keep = want > -1e30
    assert keep.sum(axis=-1).min() >= 1
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


@pytest.mark.parametrize("top_p", [0.9999999, 0.99999994])
def test_sampling_filter_top_p_cutoff_past_the_last_token(monkeypatch,
                                                          top_p):
    """Near top_p = 1 a float32 cumulative sum may end below top_p, so
    the cutoff index lies past the last token: the port must neither
    raise nor index out of range, and such a row keeps every token, as
    the JAX ``_sample``'s filling gather does. Which tail tokens fall
    within the last float32 rounding of top_p depends on each package's
    order of summation, so the masks are held to a float64 reference:
    every token whose sorted prefix before it holds less than ``top_p -
    2e-5`` of the mass (256 float32 additions err far less) is kept by
    both packages, and each package keeps a prefix of the sorted
    tokens."""
    J = _jax()
    logits = np.random.default_rng(11).normal(size=(32, 256)) \
        .astype(np.float32) * 3.0
    seen = []

    def record(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return J.jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(J.jax.random, "categorical", record)
    J.generation._sample(J.jnp.asarray(logits), J.jax.random.key(0),
                         "sampling", 1.0, 0, top_p)
    got = tgen.filter_logits(torch.from_numpy(logits), 1.0, 0,
                             top_p).numpy()
    order = np.argsort(-logits, axis=1, kind="stable")
    srt = np.take_along_axis(logits, order, axis=1)
    cum = torch.cumsum(torch.softmax(torch.from_numpy(srt), -1), -1).numpy()
    past = cum[:, -1] < np.float32(top_p)
    assert past.any()
    assert not (got[past] <= -1e30).any()
    p64 = np.exp(srt.astype(np.float64) - srt.max(1, keepdims=True))
    p64 /= p64.sum(1, keepdims=True)
    must_keep = (np.cumsum(p64, 1) - p64) < top_p - 2e-5
    for out in (got, seen[0]):
        kept = np.take_along_axis(out > -1e30, order, axis=1)
        assert kept[must_keep].all()
        assert (np.diff(kept.astype(int), axis=1) <= 0).all()


def test_sampling_in_range_and_reproducible_per_seed(models):
    _, tm = models
    prompt = np.full((3, 4), 7, np.int32)
    kw = dict(max_new_tokens=5, decode_strategy="sampling", top_k=20,
              top_p=0.9, temperature=0.8)
    a = tm.generate(prompt, seed=3, **kw).numpy()
    b = tm.generate(prompt, seed=3, **kw).numpy()
    c = tm.generate(prompt, seed=4, **kw).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tm.cfg.vocab_size
    np.testing.assert_array_equal(a[:, :4], prompt)


def test_generate_gives_the_engines_greedy_tokens(models):
    _, tm = models
    prompts = _prompts(3, 8, seed=5)
    out = tm.generate(prompts, max_new_tokens=7,
                      decode_strategy="greedy_search").numpy()
    eng = tserving.ServingEngine(tm, tserving.ServingConfig(**CFG),
                                 device="cpu")
    try:
        seqs = eng.generate(list(prompts), max_new_tokens=7)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(np.stack(seqs), out)


# -- beam search -----------------------------------------------------------------
class ToyLM:
    """The JAX test's table cell: logits from the previous token alone."""

    def __init__(self, table):
        self.table = torch.from_numpy(table)

    def __call__(self, inputs, states):
        return self.table[inputs.long()], states


def test_gather_tree_matches_jax():
    J = _jax()
    rng = np.random.default_rng(2)
    T, B, beam = 6, 3, 4
    ids = rng.integers(0, 50, (T, B, beam)).astype(np.int64)
    parents = rng.integers(0, beam, (T, B, beam)).astype(np.int64)
    want = J.nn.gather_tree(J.paddle.to_tensor(ids),
                            J.paddle.to_tensor(parents)).numpy()
    got = tnn.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tnn.gather_tree(torch.tensor([[[2, 3]], [[4, 5]], [[6, 7]]]),
                        torch.tensor([[[0, 0]], [[0, 0]], [[1, 0]]]))
        [:, 0].T.numpy(), [[2, 5, 6], [2, 4, 7]])


@pytest.mark.parametrize("V,beam,steps,seed", [(5, 5, 4, 0), (7, 3, 6, 1),
                                              (6, 2, 5, 2)])
def test_beam_search_matches_jax_on_the_table_cell(V, beam, steps, seed):
    J = _jax()
    jnp = J.jnp
    table = (np.random.default_rng(seed).normal(size=(V, V)) * 2.0) \
        .astype(np.float32)
    jdec = J.nn.BeamSearchDecoder(J.ToyLM(table), start_token=0,
                                  end_token=1, beam_size=beam)
    tdec = tnn.BeamSearchDecoder(ToyLM(table), start_token=0, end_token=1,
                                 beam_size=beam)
    B = 2
    # step by step: tokens, parents and scores of every step
    ji, js, _ = jdec.initialize(jnp.zeros((B, 1), jnp.float32))
    ti, ts, _ = tdec.initialize(torch.zeros(B, 1))
    for t in range(steps):
        jo, js, ji, _ = jdec.step(t, ji, js)
        to, ts, ti, _ = tdec.step(t, ti, ts)
        np.testing.assert_array_equal(to.predicted_ids.numpy(),
                                      np.asarray(jo.predicted_ids))
        np.testing.assert_array_equal(to.parent_ids.numpy(),
                                      np.asarray(jo.parent_ids))
        np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores),
                                   rtol=0, atol=1e-5)
    jout, jfin, jlen = J.nn.dynamic_decode(
        jdec, jnp.zeros((B, 1), jnp.float32), max_step_num=steps,
        return_length=True)
    tout, tfin, tlen = tnn.dynamic_decode(
        tdec, torch.zeros(B, 1), max_step_num=steps, return_length=True)
    np.testing.assert_array_equal(tout.numpy(), jout.numpy())
    np.testing.assert_allclose(tfin.log_probs.numpy(),
                               np.asarray(jfin.log_probs), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())
    np.testing.assert_array_equal(tfin.finished.numpy(),
                                  np.asarray(jfin.finished))
    major, _ = tnn.dynamic_decode(tdec, torch.zeros(B, 1),
                                  max_step_num=steps,
                                  output_time_major=True)
    np.testing.assert_array_equal(major.numpy(), tout.numpy()
                                  .transpose(1, 0, 2))
    if beam == V:
        # beam == V on a first-order table: exact search
        best, seq = J.brute_force(table, 0, 1, steps)
        assert tout[0, :, 0].tolist() == seq
        np.testing.assert_allclose(float(tfin.log_probs[0, 0]), best,
                                   rtol=1e-4)


def test_beam_search_states_follow_their_parent_and_contracts():
    """Cell states (a dict holding a namedtuple) are tiled to the beam
    and reordered by parent each step; a missing ``max_step_num`` or an
    empty state nest raises."""
    V, beam = 6, 3
    table = (np.random.default_rng(4).normal(size=(V, V)) * 2.0) \
        .astype(np.float32)
    Hist = GPTAttention.StaticCache

    def cell(inputs, states):
        # each row's history of fed tokens rides in its state
        hist = states["h"]
        return (torch.from_numpy(table)[inputs.long()],
                {"h": Hist(torch.cat([hist.k, inputs[:, None]], 1),
                           hist.v)})

    dec = tnn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                beam_size=beam)
    init = {"h": Hist(torch.zeros(2, 0, dtype=torch.int64),
                      torch.arange(2))}
    inputs, states, _ = dec.initialize(init)
    assert states.cell_states["h"].v.tolist() == [0, 0, 0, 1, 1, 1]
    toks = []
    for t in range(4):
        out, states, inputs, _ = dec.step(t, inputs, states)
        toks.append(out)
    ids = tnn.gather_tree(torch.stack([o.predicted_ids for o in toks]),
                          torch.stack([o.parent_ids for o in toks]))
    hist = states.cell_states["h"].k.view(2, beam, -1)
    # a beam's state history is its backtraced path, fed one step late
    for b in range(2):
        for k in range(beam):
            assert hist[b, k, 1:].tolist() == ids[:-1, b, k].tolist()
    with pytest.raises(ValueError, match="max_step_num"):
        tnn.dynamic_decode(dec, init)
    with pytest.raises(ValueError, match="initial cell states"):
        dec.initialize({})


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S0,new", [(4, 64, 32), (2, 20, 13)])
def test_generate_on_the_card_matches_the_plain_path(cuda, B, S0, new):
    """At D = 64 on the card: the prefill through the flash forward (one
    launch a layer) and every step through the paged-decode kernel over
    the buffers as pages (one launch a layer a step); greedy tokens equal
    to the CPU plain path's, and one step's logits within 1e-4."""
    cfg = gpt_tiny(hidden_size=128, num_heads=2, num_layers=2,
                   max_position_embeddings=128, initializer_range=0.3)
    card = GPTForPretraining(cfg, device=cuda, seed=1)
    host = GPTForPretraining(cfg, device="cpu", seed=1)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    prompt = _prompts(B, S0, seed=B)
    kernels.reset_launch_counts()
    got = card.generate(prompt, max_new_tokens=new,
                        decode_strategy="greedy_search").cpu().numpy()
    counts = {k["name"]: k["launches"] for k in kernels.kernels()}
    assert counts["flash_attention_fwd"] == cfg.num_layers
    assert counts["paged_decode_attention"] == cfg.num_layers * (new - 1)
    want = host.generate(prompt, max_new_tokens=new,
                         decode_strategy="greedy_search").numpy()
    np.testing.assert_array_equal(got, want)
    L = -(-(S0 + new) // STATIC_BLOCK) * STATIC_BLOCK
    outs = []
    for m, dev in ((card, cuda), (host, torch.device("cpu"))):
        caches = [GPTAttention.StaticCache(
            torch.zeros(B, L, 2, 64, device=dev),
            torch.zeros(B, L, 2, 64, device=dev)) for _ in range(2)]
        ids = torch.from_numpy(want.astype(np.int64)).to(dev)
        with torch.no_grad():
            _, caches = m(ids[:, :S0], caches=caches, cache_pos=0)
            lg, _ = m(ids[:, S0:S0 + 1], caches=caches, cache_pos=S0)
        outs.append(lg.cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_bf16_generate_attends_in_float32_on_the_card(cuda, monkeypatch):
    """A bf16 model over the float32 static buffers: the prefill's flash
    forward takes q, k and v promoted to float32, as the JAX composition
    promotes them over its f32 buffers and as each decode step does;
    greedy tokens equal to the CPU plain path's on the same bf16
    weights."""
    import paddle_tpu_torch.models.gpt as tgpt
    cfg = gpt_tiny(hidden_size=128, num_heads=2, num_layers=2,
                   max_position_embeddings=128, initializer_range=0.3)
    card = GPTForPretraining(cfg, device=cuda, seed=1).to(
        torch.bfloat16).eval()
    host = GPTForPretraining(cfg, device="cpu", seed=1).to(
        torch.bfloat16).eval()
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    seen = []
    real = tgpt.sdpa_array

    def recording(q, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tgpt, "sdpa_array", recording)
    B, S0, new = 2, 20, 13
    prompt = _prompts(B, S0, seed=B)
    kernels.reset_launch_counts()
    got = card.generate(prompt, max_new_tokens=new,
                        decode_strategy="greedy_search").cpu().numpy()
    counts = {k["name"]: k["launches"] for k in kernels.kernels()}
    assert counts["flash_attention_fwd"] == cfg.num_layers
    assert counts["paged_decode_attention"] == cfg.num_layers * (new - 1)
    assert seen and set(seen) == {(torch.float32,) * 3}
    want = host.generate(prompt, max_new_tokens=new,
                         decode_strategy="greedy_search").numpy()
    np.testing.assert_array_equal(got, want)
