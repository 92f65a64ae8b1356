"""Rank bodies for the port's tensor-parallel serving tests
(``test_torch_tp_serving.py``).

One gloo world of two ranks runs the file's cases in order (``run``, as
in ``_torch_dist_workers``) and pickles each rank's results; the tests
hold them against the JAX engines in the parent. Every case builds a
``gpt_tiny`` engine at mp = 2 (``ServingConfig.mesh``) from the JAX
model's weights. This module imports torch and the port only, so a rank
never loads JAX.
"""

import os
import time

import numpy as np
import torch

from _torch_dist_workers import run as _run

WORLD_BUDGET_S = 240
N = 2

#: ``tests/test_serving_fleet.py``'s engine and prompts
ENGINE = dict(max_batch_slots=3, block_size=4, max_context_len=64,
              prefill_buckets=(8, 16), batch_buckets=(1, 2))
REP_PROMPT = [3, 4, 5, 3, 4, 5, 3, 4]
PROMPTS = [REP_PROMPT, [7, 8, 9, 7, 8, 9, 7, 8], [1, 2, 1, 2, 1, 2]]
#: two prompts that share two pages of four, served one after the other
SHARED = [[5, 6, 7, 8, 9, 10, 11, 12, 1, 2], [5, 6, 7, 8, 9, 10, 11, 12, 3]]


def run(out_dir: str, cases) -> None:
    """One rank of the world over this module's cases; a rank still
    running after ``WORLD_BUDGET_S`` writes its stack to ``hung<r>.txt``
    and exits."""
    import faulthandler
    import _torch_dist_workers
    hung = open(os.path.join(out_dir, f"hung{os.environ['RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(WORLD_BUDGET_S, exit=True, file=hung)
    _torch_dist_workers.CASES.update(CASES)
    _run(out_dir, cases)
    faulthandler.cancel_dump_traceback_later()


def _model(inputs):
    from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny,
                                         load_jax_weights)
    return load_jax_weights(
        GPTForPretraining(gpt_tiny(**inputs["cfg"]), device="cpu"),
        inputs["weights"])


def _engine(inputs, flags=(), clock=time.perf_counter, **kw):
    """A fresh mp = 2 engine over the JAX weights, built under
    ``flags``."""
    import contextlib
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.spmd import make_mesh
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    env.reset()
    mesh = make_mesh({"mp": N})
    cfg = dict(ENGINE, mesh=mesh)
    cfg.update(kw)
    with contextlib.ExitStack() as stack:
        for name, val in flags:
            stack.enter_context(flag_scope(name, val))
        return ServingEngine(_model(inputs), ServingConfig(**cfg),
                             device="cpu", clock=clock)


def _lists(outs):
    return [np.asarray(o).tolist() for o in outs]


def case_serve(rank, inputs, out_dir):
    """f32 and int8 pools: the prompts' greedy tokens, each pool's shape
    and the K/V bytes a rank holds; a LoRA adapter (whole weights in,
    the rank's QKV columns kept) on one request beside a base one; and
    ``generate`` over static caches of the rank's heads."""
    from paddle_tpu_torch.serving import Request
    out = {}
    for quant in ("", "int8"):
        eng = _engine(inputs, flags=(("serve_kv_quant", quant),))
        got = _lists(eng.generate(PROMPTS, max_new_tokens=6))
        c = eng.cache
        out[quant or "f32"] = {
            "tokens": got, "k": tuple(c.k.shape),
            "k_scale": None if c.k_scale is None
            else tuple(c.k_scale.shape),
            "head_block": c.head_block,
            "kv_bytes": sum(t.numel() * t.element_size()
                            for t in (c.k, c.v, c.k_scale, c.v_scale)
                            if t is not None),
            "qkv_weight": tuple(eng.params["gpt.layers.0.attn.qkv_weight"]
                                .shape),
            "messages": eng._lockstep.messages}
        eng.shutdown()
    eng = _engine(inputs, lora_adapters=2, lora_rank=4)
    eng.lora.load_adapter("x", weights=inputs["lora"])
    sts = [eng.submit(Request(p, max_new_tokens=6, adapter=a))
           for p, a in ((REP_PROMPT, "x"), (PROMPTS[1], None))]
    eng.run()
    out["lora"] = {"tokens": [list(st.generated) for st in sts],
                   "b": tuple(eng.lora.b.shape),
                   "refs": eng.lora.refcount("x")}
    eng.shutdown()
    m = _engine(inputs).model
    out["generate"] = m.generate(torch.tensor([REP_PROMPT]),
                                 max_new_tokens=6,
                                 decode_strategy="greedy_search").tolist()
    return out


def case_features(rank, inputs, out_dir):
    """Speculative decoding at k = 3 on the repetitive prompt; the
    prefix cache and 4-token prefill chunks over two prompts that share
    their first two pages, served one after the other."""
    eng = _engine(inputs, flags=(("serve_spec_k", 3),))
    spec = _lists(eng.generate([REP_PROMPT], max_new_tokens=8))
    stats = dict(eng._stats)
    eng.shutdown()
    eng = _engine(inputs, flags=(("serve_prefix_cache", True),
                                 ("serve_prefill_chunk", 4)))
    shared = [_lists(eng.generate([p], max_new_tokens=6))[0]
              for p in SHARED]
    out = {"spec": spec, "spec_proposed": stats["spec_proposed"],
           "verify": stats["verify_dispatches"], "shared": shared,
           "prefix_hits": eng.prefix_cache.stats["hits"],
           "context": eng._stats["context_prefill_dispatches"],
           "chunks": eng._stats["prefill_chunks"]}
    eng.shutdown()
    return out


def _traffic(eng):
    """Deadlines that rank 0's clock keeps and one already blown, a
    cancel latched in flight, and a pool small enough to preempt."""
    from paddle_tpu_torch.serving import Request
    sts = [eng.submit(Request(p, max_new_tokens=6, deadline_s=60.0))
           for p in PROMPTS]
    sts.append(eng.submit(Request([9, 9, 9], max_new_tokens=4,
                                  deadline_s=1e-6)))
    sts.append(eng.submit(Request(PROMPTS[2], max_new_tokens=6)))
    eng.step()
    eng.cancel(sts[1].request.request_id)
    eng.run()
    return {"tokens": [list(st.generated) for st in sts],
            "outcomes": [st.outcome for st in sts],
            "preemptions": eng.scheduler.stats["preemptions"],
            "stats": dict(eng.scheduler.stats)}


def case_skew(rank, inputs, out_dir):
    """The same traffic twice: on the ranks' own clocks, then with rank
    1's clock a fixed 1e4 s ahead and running 1000x fast (on its own
    reading every 60 s deadline would pass in 60 ms). Rank 0 decides
    for both, so the tokens and outcomes are the same."""
    out = {}
    for name, clock in (
            ("plain", time.perf_counter),
            ("skewed", time.perf_counter if rank == 0
             else lambda: 1e4 + 1e3 * time.perf_counter())):
        eng = _engine(inputs, clock=clock, num_pages=9)
        out[name] = _traffic(eng)
        ls = eng._lockstep
        # a message past the one-broadcast head takes a second
        out[name]["big"] = ls.share(list(range(3000)) if ls.leader
                                    else None)
        eng.shutdown()
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
