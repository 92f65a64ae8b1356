"""The port's serving throughput features and bf16 serving
(``paddle_tpu_torch``) against the JAX package on the CPU: the
refcounted page sharing and the radix prefix cache, the n-gram drafter,
the context-prefill attention route, chunked prefill, speculative
decoding (greedy and sampled), the MMPP and gamma arrival schedules and
the bf16 engine.

The JAX model is built from a seed and its weights are copied into the
port by name (``load_jax_weights``); the same numpy-seeded prompts go
through both engines, built under each package's own ``flag_scope``
(the two flag registries are separate), and must give the same greedy
tokens. Each test states its tolerance. The ``cuda``-marked case serves
the chat features on the card against the same engine on the CPU and
skips without a card::

    python -m pytest --noconftest -m cuda \
        tests/test_torch_serving_throughput.py
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.flags import flag_scope as jax_flag_scope
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import (LoadSpec as JaxLoadSpec,
                                RadixPrefixCache as JaxRadix,
                                Request as JaxRequest,
                                ServingConfig as JaxServingConfig,
                                ServingEngine as JaxServingEngine,
                                build_requests as jax_build_requests,
                                propose_ngram as jax_propose_ngram)
from paddle_tpu.serving.scheduler import BucketTable as JaxBucketTable
from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
from paddle_tpu_torch import inference
from paddle_tpu_torch.core import flag_scope
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny,
                                     load_jax_weights)
from paddle_tpu_torch.ops.attention import context_attention
from paddle_tpu_torch.serving import (BlockAllocator, LoadSpec,
                                      PagedKVCache, RadixPrefixCache,
                                      Request, SamplingParams, ServingConfig,
                                      ServingEngine, build_requests,
                                      propose_ngram)
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving.scheduler import BucketTable, Scheduler

# D = 64, the kernels' head dim. WIDE's init keeps greedy decoding of
# random weights from collapsing into one repeated token (tokens differ
# per prompt); TINY's default 0.02 init decodes into repetition, which
# the n-gram drafter predicts, so its drafts are accepted
TINY = dict(hidden_size=128, num_heads=2)
WIDE = dict(TINY, initializer_range=0.3)
# the JAX package's own throughput tests' engine
SMALL = dict(max_batch_slots=3, block_size=4, max_context_len=64,
             prefill_buckets=(8, 16), batch_buckets=(1, 2))
# a prompt whose greedy continuation the drafter can predict
REP_PROMPT = [3, 4, 5, 3, 4, 5, 3, 4]
FEATURES = {"prefix": {"serve_prefix_cache": True},
            "chunk": {"serve_prefill_chunk": 4},
            "spec": {"serve_spec_k": 3},
            "all": {"serve_prefix_cache": True, "serve_prefill_chunk": 4,
                    "serve_spec_k": 3}}
# the engines' counters that must agree between the packages
COUNTERS = ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
            "prefill_chunks", "verify_dispatches", "spec_proposed",
            "spec_accepted", "spec_rolled_back", "tokens_generated")


def _models(cfg):
    paddle.seed(0)
    jax_model = JaxGPT(jax_gpt_tiny(**cfg))
    jax_model.eval()
    named = {k: np.asarray(v._data)
             for k, v in jax_model.state_dict().items()}
    port = load_jax_weights(GPTForPretraining(gpt_tiny(**cfg), device="cpu"),
                            named)
    return jax_model, port


@pytest.fixture(scope="module")
def wide():
    return _models(WIDE)


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


@contextlib.contextmanager
def _flags(scope, flags):
    with contextlib.ExitStack() as stack:
        for name, value in flags.items():
            stack.enter_context(scope(name, value))
        yield


def _engines(models, flags, **cfg):
    """The JAX and the port engine over the same weights, each built
    under its own package's flags."""
    jax_model, port_model = models
    conf = dict(SMALL, **cfg)
    with _flags(jax_flag_scope, flags):
        je = JaxServingEngine(jax_model, JaxServingConfig(**conf))
    with _flags(flag_scope, flags):
        te = ServingEngine(port_model, ServingConfig(**conf), device="cpu")
    return je, te


def _prompt_set(seed=42):
    """Two prompts sharing a 10-token prefix, the repetitive prompt and
    an unrelated one (the JAX package's throughput tests' set)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(2, 250, (10,)).tolist()
    return [pre + rng.integers(2, 250, (4,)).tolist(),
            pre + rng.integers(2, 250, (7,)).tolist(),
            REP_PROMPT, rng.integers(2, 250, (5,)).tolist()]


def _generate(engine, prompts, sequential, **kw):
    """Full sequences per prompt; ``sequential`` submits them one at a
    time, so later prompts can hit the pages earlier ones donated."""
    if sequential:
        return [engine.generate([p], **kw)[0].tolist() for p in prompts]
    return [o.tolist() for o in engine.generate(prompts, **kw)]


# -- pages: refcounts, the radix tree, truncation -----------------------------
def _host_caches(num_pages=12, block_size=4, max_slots=3):
    geo = dict(num_pages=num_pages, block_size=block_size,
               max_slots=max_slots, max_blocks_per_slot=6)
    return (jkv.PagedKVCache(1, 1, 4, **geo),
            PagedKVCache(1, 1, 4, device="cpu", **geo))


@pytest.mark.parametrize("case", ["refcounts", "shared_page_stays"])
def test_allocator_refcount_contract_matches_jax(case):
    """Exact: the same page ids, refcounts and free lists as the JAX
    allocator under the same calls."""
    # the second case exhausts its pool: 3 pages besides scratch
    n = 6 if case == "refcounts" else 4
    ref, got = jkv.BlockAllocator(n), BlockAllocator(n)
    if case == "refcounts":
        for a in (ref, got):
            pages = a.alloc(2)
            assert [a.refcount(p) for p in pages] == [1, 1]
            a.incref(pages[0])
            assert a.refcount(pages[0]) == 2
            a.free(pages)
            assert a.refcount(pages[0]) == 1 and a.refcount(pages[1]) == 0
            assert a.pages_in_use == 1
            a.free([pages[0]])
            with pytest.raises(ValueError):
                a.free([pages[0]])
            with pytest.raises(ValueError):
                a.incref(pages[1])
    else:
        for a in (ref, got):
            pages = a.alloc(3)
            a.incref(pages[1])
            a.free(pages)
            assert a.refcount(pages[1]) == 1
            assert a.alloc(3) is None
            assert sorted(a.alloc(2)) == sorted([pages[0], pages[2]])
    assert list(got._free) == list(ref._free) and got._rc == ref._rc


def _radix_pair(num_pages=12):
    jc, tc = _host_caches(num_pages=num_pages)
    out = []
    for cache, cls in ((jc, JaxRadix), (tc, RadixPrefixCache)):
        pc = cls(cache)
        cache.prefix_cache = pc
        out.append((cache, pc, cache.allocator))
    return out


def test_radix_donate_match_dedup_evict_matches_jax():
    """Exact: donation, the match capped one token short, a duplicate
    donation dropped, a divergent branch sharing the head, and an
    eviction storm that leaks nothing, with the JAX tree's results."""
    results = []
    for cache, pc, alloc in _radix_pair():
        r = []
        toks = list(range(10, 22))                # 3 full pages at bs=4
        pages = alloc.alloc(3)
        r.append(pc.donate(toks, pages))
        n, hit = pc.match(toks)
        assert n == 8 and hit == pages[:2]
        assert [alloc.refcount(p) for p in hit] == [2, 2]
        alloc.free(hit)
        r.append(pc.match(toks + [99, 98]))
        alloc.free(pages)
        dup = alloc.alloc(3)
        r.append(pc.donate(toks, dup))
        assert pc.cached_pages == 3
        assert all(alloc.refcount(p) == 0 for p in dup)
        pg2 = alloc.alloc(2)
        r.append(pc.donate(toks[:4] + [77, 78, 79, 80], pg2))
        assert pc.cached_pages == 4
        assert alloc.refcount(pg2[0]) == 0 and alloc.refcount(pg2[1]) == 1
        r.append(pc.evict_for(100))
        assert pc.cached_pages == 0 and alloc.pages_in_use == 0
        r.append(dict(pc.stats))
        results.append(r)
    assert results[0] == results[1]


def test_radix_eviction_keeps_live_slot_refs():
    """Exact: eviction drops the tree's reference only; a page a live
    slot maps stays allocated until the slot frees it."""
    for cache, pc, alloc in _radix_pair():
        toks = list(range(30, 38))
        pages = alloc.alloc(2)
        pc.donate(toks, pages)
        n, hit = pc.match(toks + [1, 2])
        assert hit == pages
        pc.evict_for(100)
        assert pc.cached_pages == 0
        assert all(alloc.refcount(p) == 1 for p in pages)
        alloc.free(pages)
        assert alloc.pages_in_use == 0


def test_alloc_slot_failure_drops_shared_refs():
    """Exact, both packages: a failed admission with shared pages first
    evicts the tree (which frees nothing: the pages are match-held),
    then drops the match's references, so no page leaks."""
    for cache, pc, alloc in _radix_pair(num_pages=4):
        pages = alloc.alloc(2)
        pc.donate(list(range(8)), pages)
        n, hit = pc.match(list(range(8)) + [5, 6, 7, 8, 9])
        assert len(hit) == 2
        assert not cache.alloc_slot(0, 20, shared_pages=hit)
        assert pc.cached_pages == 0
        assert all(alloc.refcount(p) == 0 for p in pages)
        assert alloc.pages_in_use == 0


def test_truncate_and_shared_prefix_guard_match_jax():
    """Exact: truncation releases only tail pages, is idempotent, clears
    the table's tail, and refuses to cut into a shared prefix."""
    for cache, pc, alloc in _radix_pair():
        assert cache.alloc_slot(0, 20)            # 5 blocks
        assert cache.truncate_slot(0, 9) == 2     # 9 tokens -> 3 blocks
        assert alloc.pages_in_use == 3
        assert cache.truncate_slot(0, 9) == 0
        table = np.asarray(cache.table_array())
        assert (table[0, 3:] == 0).all()
        shared = alloc.alloc(2)
        pc.donate(list(range(8)), shared)
        _, hit = pc.match(list(range(8)) + [1])
        assert cache.alloc_slot(1, 12, shared_pages=hit)
        assert cache.slot_shared_blocks(1) == 2
        with pytest.raises(ValueError, match="shared"):
            cache.truncate_slot(1, 4)
        cache.free_slot(1, donate_tokens=list(range(8)) + [1, 2, 3, 4])
        assert cache.slot_shared_blocks(1) == 0


def test_propose_ngram_matches_jax():
    """Exact: the JAX package's cases and 200 random histories over a
    small vocabulary (so n-grams recur) at every k and n-gram bound."""
    cases = [([3, 4, 5, 3, 4], 3, 3), ([1, 2, 3, 9, 2, 3, 7, 1, 2, 3], 2, 3),
             ([1, 2, 3, 4, 5], 4, 3), ([3, 4, 5, 3, 4], 1, 3), ([7], 2, 3)]
    rng = np.random.default_rng(0)
    for _ in range(200):
        cases.append((rng.integers(0, 6, (int(rng.integers(1, 30)),))
                      .tolist(), int(rng.integers(0, 6)),
                      int(rng.integers(1, 5))))
    assert propose_ngram([3, 4, 5, 3, 4], k=3).tolist() == [5, 3, 4]
    for toks, k, n in cases:
        got = propose_ngram(toks, k, max_ngram=n)
        ref = jax_propose_ngram(toks, k, max_ngram=n)
        assert got.dtype == ref.dtype and got.tolist() == ref.tolist()


def _fuzz_op(rng, scheds, caches, pcs, submitted, prefixes):
    """One random scheduler operation, applied to the JAX and the port
    scheduler alike (index 0 and 1)."""
    op = int(rng.integers(0, 6))
    if op == 0:
        pre = prefixes[int(rng.integers(0, len(prefixes)))]
        prompt = pre + rng.integers(1, 99, (int(rng.integers(1, 5)),)
                                    ).tolist()
        new = int(rng.integers(1, 6))
        outs = []
        for sched, req in zip(scheds, (JaxRequest, Request)):
            try:
                outs.append(sched.submit(req(prompt, max_new_tokens=new)))
            except ValueError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            submitted.append(outs)
    elif op == 1:
        for sched in scheds:
            sched.plan_admissions()
            for _, st in sched.active():
                if st.prefilling:
                    st.prefill_pos = st.prefill_len
    elif op == 2:
        tok = int(rng.integers(1, 99))
        for sched in scheds:
            sched.ensure_decode_capacity()
            for _, st in list(sched.active()):
                if st.prefilling:
                    continue
                st.generated.append(tok)
                if st.is_done():
                    sched.finish(st)
    elif op == 3:
        act = scheds[0].active()
        if act and rng.random() < 0.4:
            slot = act[int(rng.integers(0, len(act)))][0]
            for sched in scheds:
                sched.fail(sched.slots[slot], "fuzz")
    elif op == 4:
        n = int(rng.integers(1, 4))
        for pc in pcs:
            pc.evict_for(n)
    else:
        # a staged draft of 1-3 tokens on every decoding slot, then the
        # capacity pass that must give it pages, then a rollback
        for sched, cache in zip(scheds, caches):
            for slot, st in sched.active():
                if not st.prefilling:
                    st.draft = [1] * min(3, st.remaining_new_tokens())
            sched.ensure_decode_capacity()
            for slot, st in sched.active():
                if not st.prefilling:
                    assert cache.slot_blocks(slot) * cache.block_size \
                        >= st.seq_len + len(st.draft)
                    st.draft = []
                    cache.truncate_slot(slot, st.seq_len)


def _fuzz_state(sched, cache, pc):
    alloc = cache.allocator
    free = list(alloc._free)
    assert len(free) == len(set(free))
    mapped = {}
    for pages in cache._slot_pages:
        for p in pages:
            mapped[p] = mapped.get(p, 0) + 1
    for p in pc._nodes:
        mapped[p] = mapped.get(p, 0) + 1
    assert mapped == dict(alloc._rc)          # refcount == mappings
    assert not set(mapped) & set(free)
    for slot, st in sched.active():
        assert st.prefill_pos >= \
            cache.slot_shared_blocks(slot) * cache.block_size
    return (np.asarray(cache.table_array()).tolist(), free,
            sorted(alloc._rc.items()), sorted(pc._nodes),
            [None if st is None else (st.prefill_pos, st.prefill_len,
                                      len(st.generated))
             for st in sched.slots], len(sched.waiting),
            {k: sched.stats[k] for k in ("submitted", "admitted",
                                         "completed", "failed",
                                         "preemptions")})


def test_scheduler_fuzz_lockstep_with_jax():
    """300 random interleavings of submit / admit (with prefix matches)
    / decode / finish / fail / eviction / draft-and-rollback run on the
    JAX and the port scheduler in lockstep: after every step the block
    tables, free lists, refcounts, cached pages, slot states and stats
    are identical (exact), every refcount equals the page's mappings,
    and no prefill cursor sits below its shared prefix. Finishing and
    an eviction storm leave no page allocated."""
    caches = _host_caches(num_pages=14)
    pcs = [JaxRadix(caches[0]), RadixPrefixCache(caches[1])]
    for c, pc in zip(caches, pcs):
        c.prefix_cache = pc
    scheds = [JaxScheduler(caches[0], JaxBucketTable((8, 16, 24), (1, 2)),
                           max_queue=32),
              Scheduler(caches[1], BucketTable((8, 16, 24), (1, 2)),
                        max_queue=32)]
    rng = np.random.default_rng(777)
    prefixes = [rng.integers(1, 99, (8,)).tolist() for _ in range(3)]
    submitted = []
    for _ in range(300):
        _fuzz_op(rng, scheds, caches, pcs, submitted, prefixes)
        states = [_fuzz_state(s, c, p) for s, c, p in zip(scheds, caches,
                                                           pcs)]
        assert states[0] == states[1]
    assert pcs[1].stats["hits"] > 0 and scheds[1].stats["failed"] > 0
    for sched in scheds:
        guard = 0
        while sched.has_work:
            sched.plan_admissions()
            for _, st in sched.active():
                if st.prefilling:
                    st.prefill_pos = st.prefill_len
            sched.ensure_decode_capacity()
            for _, st in list(sched.active()):
                st.generated.append(1)
                if st.is_done():
                    sched.finish(st)
            guard += 1
            assert guard < 2000
    for cache, pc in zip(caches, pcs):
        pc.evict_for(10_000)
        assert cache.allocator.pages_in_use == 0


@pytest.mark.parametrize("outcome", ["completed", "failed", "preempted"])
def test_donation_on_finish_and_preemption_not_after_failure(outcome):
    """A completed or preempted residency donates the full pages of the
    tokens its pages validly hold; a failed one donates nothing. Exact
    against the JAX scheduler."""
    caches = _host_caches(num_pages=14)
    cached = []
    for cache, (sched_cls, buckets, req, radix) in zip(caches, (
            (JaxScheduler, JaxBucketTable, JaxRequest, JaxRadix),
            (Scheduler, BucketTable, Request, RadixPrefixCache))):
        pc = radix(cache)
        cache.prefix_cache = pc
        sched = sched_cls(cache, buckets((16,), (1, 2)))
        st = sched.submit(req(list(range(1, 11)), max_new_tokens=4))
        other = sched.submit(req([50, 51], max_new_tokens=4))
        sched.plan_admissions()
        for s in (st, other):
            s.prefill_pos = s.prefill_len
            s.generated.append(7)
        st.generated.append(8)
        if outcome == "completed":
            sched.finish(st)
        elif outcome == "failed":
            sched.fail(st, "test")
        else:
            sched._preempt(st)
            assert sched.waiting[0] is st and st.prefill_pos == 0
        cached.append((pc.cached_pages, cache.allocator.pages_in_use,
                       sorted(pc._nodes)))
    assert cached[0] == cached[1]
    # 10 prompt tokens + 1 written generated token: two full pages
    assert cached[1][0] == (0 if outcome == "failed" else 2)


# -- the context-prefill route ------------------------------------------------
def _jax_ctx_mask(n_cols, pos, S):
    """``models/gpt.py``'s ``_ctx_mask``: ``[B, 1, S, Lk]``, 0 where
    ``col <= pos + i``, else -1e30."""
    cols = jnp.arange(n_cols, dtype=jnp.int32)
    rows = jnp.asarray(pos)[:, None] + jnp.arange(S, dtype=jnp.int32)[None]
    return jnp.where(cols[None, None, :] <= rows[:, :, None], 0.0,
                     -1e30)[:, None]


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("S", [1, 5, 16])
def test_context_route_matches_jax_mask_composition(S, quant):
    """``context_index`` + ``gather_context`` + ``context_attention``
    against the JAX context path (``gather_pages`` + ``_ctx_mask`` +
    ``sdpa_array``) on the same pools at ragged positions (0, mid-page,
    a page edge, the last rows of the table), including a padded row
    with an all-scratch table: within 1e-5 (f32 sums of the same
    products over a differently placed context; int8 dequantized the
    same way in both)."""
    from paddle_tpu.ops.attention import sdpa_array as jax_sdpa
    B, H, D, bs, MB, P = 5, 2, 64, 4, 8, 40
    rng = np.random.default_rng(S)
    pos = np.array([0, 6, 8, MB * bs - S, 0], np.int32)
    table = np.zeros((B, MB), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B - 1):                     # the last row is padding
        n = (int(pos[b]) + S - 1) // bs + 1
        table[b, :n] = perm[b * MB:b * MB + n]
    kp, vp = (rng.standard_normal((P, bs, H, D)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    if quant:
        ks, vs = (np.abs(rng.standard_normal((P, bs, H))).astype(
            np.float32) * 0.02 for _ in range(2))
        kq, vq = (np.clip(np.round(x * 40), -127, 127).astype(np.int8)
                  for x in (kp, vp))
        gk = jkv.gather_pages_quant(jnp.asarray(kq), jnp.asarray(ks),
                                    jnp.asarray(table))
        gv = jkv.gather_pages_quant(jnp.asarray(vq), jnp.asarray(vs),
                                    jnp.asarray(table))
    else:
        gk = jkv.gather_pages(jnp.asarray(kp), jnp.asarray(table))
        gv = jkv.gather_pages(jnp.asarray(vp), jnp.asarray(table))
    ref = np.asarray(jax_sdpa(jnp.asarray(q), gk, gv,
                              mask=_jax_ctx_mask(gk.shape[1], pos, S)))
    ctx = tkv.context_index(table, pos, S, bs, "cpu")
    assert ctx.pages.shape == (B, MB * bs)
    if quant:
        kc = tkv.gather_context_quant(torch.from_numpy(kq),
                                      torch.from_numpy(ks), ctx)
        vc = tkv.gather_context_quant(torch.from_numpy(vq),
                                      torch.from_numpy(vs), ctx)
    else:
        kc = tkv.gather_context(torch.from_numpy(kp), ctx)
        vc = tkv.gather_context(torch.from_numpy(vp), ctx)
    got = context_attention(torch.from_numpy(q), kc, vc, ctx.bias).numpy()
    np.testing.assert_allclose(got[:B - 1], ref[:B - 1], atol=1e-5, rtol=0)


def test_context_index_widens_past_the_table():
    """A window that runs past the table (a verify window's padded rows
    near the end of the context) widens the context to ``pos + S``
    columns, so every valid position stays in it; positions past the
    table read the scratch page; nothing left of position 0 is
    unmasked. Exact."""
    table = np.arange(1, 9, dtype=np.int32).reshape(1, 8)   # bs 4: 32
    ctx = tkv.context_index(table, np.array([30]), 5, 4, "cpu")
    assert ctx.pages.shape == (1, 35)
    pages, offs = ctx.pages[0].tolist(), ctx.offsets[0].tolist()
    assert [(pages[j], offs[j]) for j in (0, 29, 31)] == \
        [(1, 0), (8, 1), (8, 3)]
    assert pages[32:] == [0, 0, 0] and bool((ctx.bias == 0).all())
    ctx = tkv.context_index(table, np.array([3]), 2, 4, "cpu")
    assert ctx.pages.shape == (1, 32)
    assert bool((ctx.bias[0, :27] == -1e30).all())
    assert bool((ctx.bias[0, 27:] == 0).all())
    assert ctx.pages[0, 27:].tolist() == [1, 1, 1, 1, 2]


def test_context_forward_logits_match_jax(wide):
    """The model's context-prefill forward (a 6-token chunk continuing
    two slots at ragged positions over pages a first chunk wrote, a
    padded row beside them) against the JAX model's with its
    ``ContextPagedCacheView``: logits within 1e-4 (f32 sums in other
    orders over 2 layers), and the pools within 1e-4."""
    jm, port_model = wide
    cfg = port_model.cfg
    geo = dict(num_pages=16, block_size=4, max_slots=3,
               max_blocks_per_slot=6)
    jc = jkv.PagedKVCache(cfg.num_layers, cfg.num_heads, cfg.head_dim,
                          **geo)
    tc = PagedKVCache(cfg.num_layers, cfg.num_heads, cfg.head_dim,
                      device="cpu", **geo)
    for c in (jc, tc):
        assert c.alloc_slot(0, 16) and c.alloc_slot(1, 13)
    rng = np.random.RandomState(2)
    first = rng.randint(0, 256, (3, 8)).astype(np.int32)
    second = rng.randint(0, 256, (3, 6)).astype(np.int32)
    rows = [0, 1, None]

    def jax_step(ids, pos, ctx):
        cls = jkv.ContextPagedCacheView if ctx else jkv.PagedCacheView
        view = cls(jc.k, jc.v, jc.table_array(rows))
        with paddle.no_grad():
            lg, nc = jm(paddle.to_tensor(ids), caches=view,
                        cache_pos=paddle.to_tensor(pos))
        jc.update(nc.k._data, nc.v._data)
        return np.asarray(lg._data)

    def port_step(ids, pos, ctx):
        table = tc.table_rows(rows)
        args = (tc.k, tc.v, torch.from_numpy(table))
        view = (tkv.ContextPagedCacheView(
            *args, context=tkv.context_index(table, pos, ids.shape[1], 4,
                                             "cpu"))
            if ctx else tkv.PagedCacheView(*args))
        with torch.no_grad():
            return port_model(torch.from_numpy(ids.astype(np.int64)),
                              caches=view,
                              cache_pos=torch.from_numpy(pos)).numpy()

    zeros = np.zeros(3, np.int32)
    np.testing.assert_allclose(port_step(first, zeros, False),
                               jax_step(first, zeros, False), atol=1e-4,
                               rtol=0)
    pos = np.array([8, 7, 0], np.int32)
    ref, got = jax_step(second, pos, True), port_step(second, pos, True)
    np.testing.assert_allclose(got[:2], ref[:2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jc.k)[:, 1:],
                               atol=1e-4, rtol=0)


# -- the engines --------------------------------------------------------------
@pytest.mark.parametrize("feature", ["prefix", "chunk", "spec", "all"])
@pytest.mark.parametrize("model", ["wide", "tiny"])
def test_feature_engines_greedy_token_exact_vs_jax(request, feature, model):
    """Greedy tokens exact against the JAX engine with each feature
    alone and all three composed, and against the port's own flags-off
    engine; the dispatch, chunk, prefix-hit and draft counters equal
    the JAX engine's exactly. Prompts run one at a time under the
    prefix cache (a hit needs an earlier request's donation)."""
    models = request.getfixturevalue(model)
    flags = FEATURES[feature]
    prompts = _prompt_set()
    sequential = "serve_prefix_cache" in flags
    je, te = _engines(models, flags)
    ref = _generate(je, prompts, sequential, max_new_tokens=6)
    got = _generate(te, prompts, sequential, max_new_tokens=6)
    off = _generate(_engines(models, {})[1], prompts, sequential,
                    max_new_tokens=6)
    assert got == ref == off
    for k in COUNTERS:
        assert te._stats[k] == je._stats[k], k
    m = te.metrics_summary()
    if "serve_prefix_cache" in flags:
        assert m["prefix_hit_tokens"] == \
            je.prefix_cache.stats["hit_tokens"] > 0
        assert m["prefix_hit_pct"] > 0
        assert te.cache.allocator.pages_in_use == \
            te.prefix_cache.cached_pages
        te.shutdown()
        assert te.cache.allocator.pages_in_use == 0
    if "serve_prefill_chunk" in flags:
        assert m["prefill_chunks"] > len(prompts)
        assert te._stats["context_prefill_dispatches"] > 0
    if "serve_spec_k" in flags:
        assert m["spec_proposed"] > 0 and te._stats["verify_dispatches"] > 0
        assert m["spec_proposed"] == m["spec_accepted"] \
            + m["spec_rolled_back"]
        if model == "tiny":
            assert m["spec_accepted"] > 0 and m["spec_accept_pct"] > 0


def test_chunked_prefill_interleaves_and_never_writes_prefilling_pages(
        wide):
    """A long prompt chunking at 4 tokens beside a short request that
    decodes between its chunks: the short request completes while the
    long one is still prefilling, the decode and verify dispatches of
    those steps leave the long slot's first page untouched (bit-equal),
    and both streams equal the JAX engine's (exact)."""
    long_p = np.random.default_rng(6).integers(2, 250, (48,)).tolist()
    cfg = dict(max_context_len=64, prefill_buckets=(4, 8, 16, 64))
    flags = {"serve_prefill_chunk": 4, "serve_spec_k": 2}
    je, te = _engines(wide, flags, **cfg)
    outs = []
    for eng, req in ((je, JaxRequest), (te, Request)):
        st_long = eng.submit(req(long_p, max_new_tokens=2))
        eng.step()
        assert st_long.prefilling
        if eng is te:
            head = te.cache._slot_pages[st_long.slot][0]
            k_before = te.cache.k[:, head].clone()
        st_short = eng.submit(req(REP_PROMPT, max_new_tokens=8))
        while st_long.prefilling:
            eng.step()
            if eng is te:
                assert torch.equal(k_before, te.cache.k[:, head])
        # the short stream completed between the long prompt's chunks
        assert st_short.terminal
        eng.run()
        outs.append((st_long.generated, st_short.generated))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("num_pages", [None, 14],
                         ids=["resident", "preempting"])
def test_int8_lora_engine_with_features_token_exact_vs_jax(wide, num_pages):
    """int8 pools (``serve_kv_quant``) and two LoRA adapters mixed in one
    batch, with the prefix cache, chunks of 4 and spec k = 3: greedy
    tokens exact against the JAX engine, with and without
    recompute-preemption; context dispatches ran (over int8 pools and
    adapter rows), every adapter reference and every slot page is
    released at the end."""
    rng = np.random.default_rng(11)
    adapters = {n: (rng.standard_normal((2, 4, 128)).astype(np.float32)
                    * 0.5,
                    rng.standard_normal((2, 4, 384)).astype(np.float32)
                    * 0.5) for n in ("t0/a", "t1/b")}
    flags = dict(FEATURES["all"])
    cfg = dict(num_pages=num_pages, lora_adapters=2, lora_rank=4)
    with jax_flag_scope("serve_kv_quant", "int8"), \
            flag_scope("serve_kv_quant", "int8"):
        je, te = _engines(wide, flags, **cfg)
    assert te.cache.k.dtype == torch.int8
    for e in (je, te):
        for name, w in adapters.items():
            e.lora.load_adapter(name, weights=w)
    prompts = _prompt_set(7)
    outs = []
    for eng, req in ((je, JaxRequest), (te, Request)):
        sts = [eng.submit(req(p, max_new_tokens=6,
                              adapter=("t0/a", None, "t1/b")[i % 3]))
               for i, p in enumerate(prompts * 2)]
        eng.run()
        outs.append([st.generated for st in sts])
    assert outs[0] == outs[1]
    assert all(len(g) == 6 for g in outs[1])
    for k in COUNTERS:
        assert te._stats[k] == je._stats[k], k
    assert te._stats["context_prefill_dispatches"] > 0
    assert te.stats()["preemptions"] == je.scheduler.stats["preemptions"]
    assert te.stats()["lora"]["refcounts"] == {"t0/a": 0, "t1/b": 0}
    assert te.cache.allocator.pages_in_use == te.prefix_cache.cached_pages


@pytest.mark.parametrize("features", ["off", "all"])
def test_bf16_engine_matches_jax_bf16_engine(wide, features):
    """``create_serving_engine`` under ``enable_tpu_bf16`` with
    ``cache_dtype="bfloat16"``: bf16 parameters in the engine's copy (the
    layer stays f32), bf16 pools written as bf16, KV bytes a token half
    of f32's, and greedy tokens equal to the JAX bf16 engine's (exact:
    both packages round at the same points, and these prompts meet no
    bf16 tie) with the features off and all on."""
    from paddle_tpu import inference as jinf
    jax_model, port_model = wide
    flags = FEATURES[features] if features == "all" else {}
    conf = dict(SMALL, cache_dtype="bfloat16")
    with _flags(jax_flag_scope, flags):
        jcfg = jinf.Config.from_layer(jax_model, [])
        jcfg.enable_tpu_bf16()
        je = jinf.create_serving_engine(jcfg, JaxServingConfig(**conf))
    with _flags(flag_scope, flags):
        tcfg = inference.Config.from_layer(port_model, [])
        tcfg.enable_tpu_bf16()
        te = inference.create_serving_engine(tcfg, ServingConfig(**conf),
                                             device="cpu")
    assert {v.dtype for v in te.params.values()} == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in port_model.parameters())
    assert te.cache.k.dtype == te.cache.v.dtype == torch.bfloat16
    assert str(je.cache.k.dtype) == "bfloat16"
    assert te.cache.kv_bytes_per_token() == je.cache.kv_bytes_per_token() \
        == 2 * 2 * 64 * 2 * 2
    prompts = _prompt_set(3)
    sequential = bool(flags)
    ref = _generate(je, prompts, sequential, max_new_tokens=6)
    got = _generate(te, prompts, sequential, max_new_tokens=6)
    assert got == ref
    for k in COUNTERS:
        assert te._stats[k] == je._stats[k], k


def test_bf16_model_dtypes_follow_the_jax_model(wide):
    """Under a bf16 parameter copy the port's activations are bf16 where
    the JAX model's are (the embeddings' sum, layer norm's output, the
    attention and MLP outputs, the final hidden state, the logits);
    exact dtype equality."""
    from torch.func import functional_call
    jax_model, port_model = wide
    params = {k: v.to(torch.bfloat16)
              for k, v in port_model.named_parameters()}
    ids = np.zeros((1, 8), np.int32)
    seen = {}

    def keep(name):
        def hook(mod, inp, out):
            seen.setdefault(name, out.dtype)
        return hook
    hooks = [m.register_forward_hook(keep(name))
             for name, m in (("ln1", port_model.gpt.layers[0].ln1),
                             ("attn", port_model.gpt.layers[0].attn),
                             ("mlp", port_model.gpt.layers[0].mlp),
                             ("hidden", port_model.gpt))]
    try:
        with torch.no_grad():
            logits = functional_call(
                port_model, params, (torch.from_numpy(ids.astype(np.int64)),))
    finally:
        for h in hooks:
            h.remove()
    seen["logits"] = logits.dtype
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**WIDE))
    jm.eval()
    jm.to(dtype="bfloat16")
    jids = paddle.to_tensor(ids)
    emb = jm.gpt.word_embeddings(jids)
    x = jm.gpt.layers[0].ln1(emb)
    ref = {"ln1": x, "attn": jm.gpt.layers[0].attn(x),
           "mlp": jm.gpt.layers[0].mlp(x), "hidden": jm.gpt(jids),
           "logits": jm(jids)}
    for name, t in ref.items():
        assert str(t._data.dtype) == "bfloat16"
        assert seen[name] == torch.bfloat16, name


def test_bf16_and_pool_dtype_refusals(wide):
    """bf16 parameters over float32 pools and over int8 pools serve, as
    in the JAX engine (``create_serving_engine`` under
    ``enable_tpu_bf16`` keeps the default float32 ``cache_dtype``): the
    greedy tokens equal the JAX engine's, exactly, in both. What the
    port still refuses raises at the engine's construction, on the CPU
    as on the card: a pool dtype the kernels do not read, and a float32
    parameter copy over bf16 pools (the bf16 decode kernel would round
    q)."""
    from paddle_tpu import inference as jinf
    model = GPTForPretraining(gpt_tiny(**TINY), device="cpu")
    with pytest.raises(ValueError, match="cache_dtype"):
        ServingEngine(model, ServingConfig(cache_dtype="float16"),
                      device="cpu")
    with pytest.raises(ValueError, match="round q"):
        ServingEngine(model, ServingConfig(cache_dtype="bfloat16"),
                      device="cpu")
    jax_model, port_model = wide
    prompts = _prompt_set(3)
    for quant, pool in ((None, torch.float32), ("int8", torch.int8)):
        flags = {"serve_kv_quant": quant} if quant else {}
        with _flags(jax_flag_scope, flags):
            jcfg = jinf.Config.from_layer(jax_model, [])
            jcfg.enable_tpu_bf16()
            je = jinf.create_serving_engine(jcfg, JaxServingConfig(**SMALL))
        with _flags(flag_scope, flags):
            tcfg = inference.Config.from_layer(port_model, [])
            tcfg.enable_tpu_bf16()
            te = inference.create_serving_engine(
                tcfg, ServingConfig(**SMALL), device="cpu")
        assert {v.dtype for v in te.params.values()} == {torch.bfloat16}
        assert te.cache.k.dtype == pool
        ref = _generate(je, prompts, False, max_new_tokens=6)
        assert _generate(te, prompts, False, max_new_tokens=6) == ref, quant
        for k in COUNTERS:
            assert te._stats[k] == je._stats[k], k


def test_flags_off_engine_issues_no_new_dispatch_kinds(wide, monkeypatch):
    """With the four flags at their defaults: no prefix cache, no
    context view is ever built (``context_index`` would raise), no
    chunk, draft or verify is counted, and the dispatches equal the JAX
    flags-off engine's (exact)."""
    def refuse(*a, **k):
        raise AssertionError("a flags-off engine built a context view")
    monkeypatch.setattr(tengine, "context_index", refuse)
    je, te = _engines(wide, {})
    assert te.prefix_cache is None and te.cache.prefix_cache is None
    prompts = _prompt_set(5)
    assert _generate(te, prompts, False, max_new_tokens=6) == \
        _generate(je, prompts, False, max_new_tokens=6)
    s = te._stats
    assert s["context_prefill_dispatches"] == s["verify_dispatches"] == \
        s["prefill_chunks"] == s["spec_proposed"] == 0
    for k in COUNTERS:
        assert s[k] == je._stats[k], k
    m = te.metrics_summary()
    assert m["prefix_hit_pct"] is None and m["spec_accept_pct"] is None


def test_stochastic_spec_sampling_distribution_parity(tiny):
    """Sampled slots accept drafts stochastically over the verify
    dispatch (a point-mass drafter's residual rule): the marginal token
    distribution at every position must be that of plain sampled decode.
    1600 identical sampled requests through a plain port engine and a
    spec k = 3 one; per-position total-variation distance under 0.2 (the
    JAX package's own bound for this test), with drafts proposed and
    some accepted. The JAX test draws 400; at 400 two plain runs of this
    model already differ by up to 0.17 at the last position, whose
    marginal spreads over many tokens, so the port draws four times as
    many: two plain runs with other seeds then differ by at most 0.117
    and the spec run from the plain one by at most 0.094."""
    M, BATCH, NEW = 1600, 80, 4
    sp = SamplingParams(temperature=0.7, top_k=4)

    def marginals(flags):
        with _flags(flag_scope, flags):
            eng = ServingEngine(tiny[1], ServingConfig(
                **dict(SMALL, max_batch_slots=8, batch_buckets=(1, 2, 4, 8))),
                device="cpu")
        counts = np.zeros((NEW, 256))
        for _ in range(M // BATCH):
            for o in eng.generate([REP_PROMPT] * BATCH, max_new_tokens=NEW,
                                  sampling=sp):
                for pos in range(NEW):
                    counts[pos, int(o[len(REP_PROMPT) + pos])] += 1
        return counts / M, dict(eng._stats)

    plain, _ = marginals({})
    spec, st = marginals({"serve_spec_k": 3})
    assert st["spec_proposed"] > 0 and st["spec_accepted"] > 0
    for pos in range(NEW):
        tv = 0.5 * np.abs(plain[pos] - spec[pos]).sum()
        assert tv < 0.2, f"position {pos}: TV {tv:.3f}"


def test_verify_draws_match_their_definition():
    """``verify_draws``: p_draft is each row's filtered softmax mass on
    the drafted token (within 1e-6 of ``filtered_logits`` + softmax
    computed row by row); a residual redraw never returns the drafted
    token; a fresh sample stays inside the row's top-k."""
    from paddle_tpu_torch.serving import filtered_logits
    from paddle_tpu_torch.serving.sampling import verify_draws
    g = torch.Generator().manual_seed(0)
    B, S, V = 3, 4, 32
    logits = torch.randn(B, S, V, generator=g) * 2
    drafts = torch.randint(0, V, (B, S - 1), generator=g)
    temps = torch.tensor([0.7, 1.0, 1.5])
    top_k = torch.tensor([4, 0, 8])
    top_p = torch.tensor([1.0, 0.9, 1.0])
    p_draft, full, resid = verify_draws(logits, drafts, temps, top_k, top_p,
                                        generator=g)
    for b in range(B):
        flt = filtered_logits(logits[b], temps[b].repeat(S),
                              top_k[b].repeat(S), top_p[b].repeat(S))
        probs = torch.softmax(flt, -1)
        want = probs[torch.arange(S - 1), drafts[b]]
        np.testing.assert_allclose(p_draft[b].numpy(), want.numpy(),
                                   atol=1e-6, rtol=0)
        assert bool((probs.gather(1, full[b][:, None]) > 0).all())
    assert bool((resid != drafts).all())


# -- the open-loop schedule ---------------------------------------------------
@pytest.mark.parametrize("spec", [
    dict(num_requests=24, rate_rps=4.0, prompt_len_range=(16, 64),
         max_new_range=(16, 48), vocab_size=50304, seed=7, arrival="mmpp",
         burstiness=2.0, shared_prefix_len=256, prefix_pool_size=4,
         prefix_zipf=1.2),
    dict(num_requests=40, rate_rps=10.0, seed=3, arrival="mmpp",
         burstiness=4.0, mmpp_switch=0.3),
    dict(num_requests=30, rate_rps=6.0, seed=5, arrival="gamma",
         burstiness=2.0),
    dict(num_requests=30, rate_rps=6.0, seed=5, arrival="gamma",
         burstiness=0.5, shared_prefix_len=8, tenants=2, adapter_pool=2),
    dict(num_requests=12, rate_rps=6.0, seed=5, arrival="gamma",
         burstiness=1.0),
], ids=["chat", "mmpp", "gamma_bursty", "gamma_smooth_tenants",
        "gamma_poisson"])
def test_arrival_schedules_byte_identical_to_jax(spec):
    """Exact: every arrival time, prompt byte, token budget, tenant and
    adapter of the JAX schedule for the same spec and seed."""
    ref = jax_build_requests(JaxLoadSpec(**spec))
    got = build_requests(LoadSpec(**spec))
    assert len(got) == len(ref) == spec["num_requests"]
    for (ta, ra), (tb, rb) in zip(ref, got):
        assert ta == tb
        assert ra.prompt.tobytes() == rb.prompt.tobytes()
        assert (ra.max_new_tokens, ra.tenant, ra.adapter) == \
            (rb.max_new_tokens, rb.tenant, rb.adapter)
    gaps = np.diff([t for t, _ in got])
    assert gaps.min() >= 0.0


def test_arrival_spec_refusals():
    with pytest.raises(ValueError, match="arrival mode"):
        build_requests(LoadSpec(arrival="uniform"))
    with pytest.raises(ValueError, match="burstiness"):
        build_requests(LoadSpec(arrival="gamma", burstiness=0.0))


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chat_engine_on_card_matches_cpu(cuda):
    """The chat features (prefix cache, chunks of 4, spec k = 3) on the
    card against the same engine on the CPU, same weights: greedy tokens
    equal (exact; the WIDE init leaves these prompts no near-tie), the
    same counters, and the card's engine launched the causal biased
    flash kernel once per layer per context prefill and verify
    dispatch."""
    from paddle_tpu_torch.ops import kernels
    cfg = gpt_tiny(**WIDE)
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=1)
    card_model = GPTForPretraining(cfg, device=cuda, seed=1)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = _prompt_set(9)
    out, stats = [], []
    for model, dev in ((cpu_model, "cpu"), (card_model, cuda)):
        with _flags(flag_scope, FEATURES["all"]):
            eng = ServingEngine(model, ServingConfig(**SMALL), device=dev)
        before = kernels.FLASH_ATTENTION_BIAS_FWD.launches
        out.append(_generate(eng, prompts, True, max_new_tokens=6))
        stats.append(dict(eng._stats))
    assert out[0] == out[1]
    assert stats[0] == stats[1]
    n_ctx = stats[1]["context_prefill_dispatches"] + \
        stats[1]["verify_dispatches"]
    assert kernels.FLASH_ATTENTION_BIAS_FWD.launches - before == \
        cfg.num_layers * n_ctx > 0
