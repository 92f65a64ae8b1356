#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``paddle_tpu``, and it has no
fallback: any failure raises and the script exits non-zero without its
result line. Four phases, in order:

1. card    -- print the card's name and power limit (``nvidia-smi``),
              build every kernel from ``paddle_tpu_torch/csrc`` with
              ``nvcc`` (one process per source, all at once);
2. kernels -- hold each kernel against its plain PyTorch version on the
              card at the serving path's shapes, and time the kernel,
              the plain version, the card's bound and, where one exists,
              the one PyTorch call that computes the same function;
3. slice   -- serve 16 greedy requests on GPT-2 345M (random weights
              from a seed) through ``ServingEngine`` at the full serving
              configuration, check the launch counts against the
              dispatch counts and cross-check every generated token
              against a teacher-forced no-cache forward;
4. summary -- print one JSON line describing every ported kernel, then
              the result line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or in a directory that holds this script and
nothing else of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# tolerances of kernel vs plain version, max abs error
TOL = {
    # the kernel sums the same products in another order
    "float32": 1e-4,
    # both round p.V to bfloat16 output; the kernel keeps p in f32
    "bfloat16": 2e-2,
}

# the serving path measured here is bench.py --serve at full width
SERVE_CFG = dict(max_batch_slots=8, block_size=16, max_context_len=512,
                 prefill_buckets=(128, 256), batch_buckets=(1, 2, 4))
NUM_REQUESTS = 16
PROMPT_RANGE = (64, 224)
NEW_TOKENS_RANGE = (16, 48)
# a teacher-forced position may pick another token than the engine only
# where the engine's token is within this of the maximum logit (a tie
# that the summation order of the paged and no-cache paths may break
# either way)
TIE_GAP = 1e-3


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _median_ms(fn, iters: int = 30, warmup: int = 5, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each timed
    by its own pair of CUDA events. ``flush`` (not timed) runs before
    every launch where the real caller finds the inputs cold in L2."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 -----------------------------------------------------------------
def phase_card() -> dict:
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    _require(out, "nvidia-smi printed no card")
    _log(out[0])
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from paddle_tpu_torch.ops import kernels
    secs = kernels.build()
    _log(f"card: built {len(kernels.KERNELS)} kernels in {secs:.2f} s")
    for name in kernels.KERNELS:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")
    return {"smi": out[0]}


# -- phase 2 -----------------------------------------------------------------
def _flash_case(B, S, H, D, dtype, seed, timed=False):
    import torch
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
               .to(dtype) for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    name = str(dtype).replace("torch.", "")
    _log(f"kernels: flash_attention_fwd B={B} S={S} H={H} D={D} {name} "
         f"causal: max|o-plain| {err:.3e}, max|lse-plain| {lse_err:.3e} "
         f"(tol {TOL[name]:g})")
    _require(math.isfinite(err) and err <= TOL[name],
             f"flash_attention_fwd disagrees with its plain version "
             f"({err} > {TOL[name]}) at S={S} {name}")
    _require(lse_err <= TOL["float32"] * 10,
             f"flash lse disagrees with its plain version ({lse_err})")
    if not timed:
        return None
    ms = _median_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = _median_ms(lambda: flash_attention_plain(q, k, v,
                                                        causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = _median_ms(lambda: torch.nn.functional.
                        scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True))
    elem = q.element_size()
    nbytes = 4 * B * S * H * D * elem          # q, k, v read; o written
    pairs = S * (S + 1) // 2                   # causal (row, col) pairs
    flops = 4 * B * H * D * pairs              # q.k and p.v
    bound, by = _bound_ms(nbytes, flops, name)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "shape": f"B={B} S={S} H={H} D={D} {name} causal"}


def _paged_case(dtype, seed, timed=False):
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention, paged_decode_plain)
    B, MB, bs, H, D, P = 8, 32, 16, 16, 64, 257
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(P, bs, H, D, device="cuda", generator=g).to(dtype)
    vp = torch.randn(P, bs, H, D, device="cuda", generator=g).to(dtype)
    q = torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
    # slot 0 inactive (pos 0, all-scratch row); the others span 0,
    # mid-page, page boundaries and the last position 511
    pos = np.array([0, 0, 7, 15, 16, 200, 300, 511], np.int32)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, MB), np.int32)
    used = 0
    for b in range(1, B):
        n = int(pos[b]) // bs + 1
        table[b, :n] = perm[used:used + n]
        used += n
    tbl = torch.from_numpy(table).cuda()
    pos_t = torch.from_numpy(pos).cuda()
    scale = 1.0 / math.sqrt(D)
    out = paged_decode_attention(q, kp, vp, tbl, pos_t, scale)
    ref = paged_decode_plain(q, kp, vp, tbl, pos_t, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    name = str(dtype).replace("torch.", "")
    _log(f"kernels: paged_decode_attention B={B} MB={MB} bs={bs} H={H} "
         f"D={D} P={P} {name} pos={pos.tolist()}: max|o-plain| "
         f"{err:.3e} (tol {TOL[name]:g})")
    _require(math.isfinite(err) and err <= TOL[name],
             f"paged_decode_attention disagrees with its plain version "
             f"({err} > {TOL[name]}) in {name}")
    if not timed:
        return None
    # a decode step reads each layer's pools once: cold in L2 (50 MB) for
    # the real caller, so the cache is flushed before every timed launch
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = _median_ms(lambda: paged_decode_attention(q, kp, vp, tbl, pos_t,
                                                   scale),
                    flush=scrub.zero_)
    plain_ms = _median_ms(lambda: paged_decode_plain(q, kp, vp, tbl, pos_t,
                                                     scale),
                          flush=scrub.zero_)
    elem = q.element_size()
    visible = np.minimum(pos, MB * bs - 1).astype(np.int64) + 1
    nbytes = (int(visible.sum()) * H * D * 2 * elem   # K and V rows read
              + 2 * B * H * D * elem                  # q read, out written
              + table.nbytes + pos.nbytes)
    flops = 4 * H * D * int(visible.sum())
    bound, by = _bound_ms(nbytes, flops, name)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"B={B} MB={MB} bs={bs} H={H} D={D} P={P} {name}"}


def phase_kernels() -> dict:
    import torch
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S in (128, 200):
            _flash_case(4, S, 16, 64, dtype, seed=S)
    _flash_case(2, 256, 8, 128, torch.float32, seed=3)
    _flash_case(4, 256, 16, 64, torch.bfloat16, seed=256)
    # the serving path runs float32 (the engine's cache dtype): time that
    rows["flash_attention_fwd"] = _flash_case(4, 256, 16, 64, torch.float32,
                                              seed=256, timed=True)
    _paged_case(torch.bfloat16, seed=1)
    rows["paged_decode_attention"] = _paged_case(torch.float32, seed=1,
                                                 timed=True)
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        _log(f"kernels: {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}), library {lib} ms")
    return rows


# -- phase 3 -----------------------------------------------------------------
def phase_slice() -> dict:
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (Request, SamplingParams,
                                          ServingConfig, ServingEngine)
    cfg = gpt2_medium()
    t0 = time.perf_counter()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    engine = ServingEngine(model, ServingConfig(**SERVE_CFG),
                           device="cuda")
    n_kernels = engine.warmup()
    torch.cuda.synchronize()
    _log(f"slice: gpt2_medium ({sum(p.numel() for p in model.parameters())}"
         f" parameters, {cfg.num_layers} layers) and engine ready in "
         f"{time.perf_counter() - t0:.2f} s; {n_kernels} kernels loaded; "
         f"config {engine.config.prefill_buckets} x "
         f"{engine.config.batch_buckets}, {engine.config.num_pages} pages")
    rng = np.random.RandomState(0)
    specs = []
    for _ in range(NUM_REQUESTS):
        n = int(rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1))
        new = int(rng.randint(NEW_TOKENS_RANGE[0], NEW_TOKENS_RANGE[1] + 1))
        specs.append((rng.randint(0, cfg.vocab_size, (n,)), new))

    kernels.reset_launch_counts()
    states = [engine.submit(Request(p, max_new_tokens=new,
                                    sampling=SamplingParams()))
              for p, new in specs]
    engine.run()
    torch.cuda.synchronize()
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}

    stats = engine.stats()
    summary = engine.metrics_summary()
    for st, (p, new) in zip(states, specs):
        _require(st.outcome == "completed",
                 f"request {st.request.request_id} ended {st.outcome} "
                 f"({st.failure})")
        _require(len(st.generated) == new,
                 f"request {st.request.request_id}: {len(st.generated)} "
                 f"tokens, asked for {new}")
    L = cfg.num_layers
    n_pre, n_dec = stats["prefill_dispatches"], stats["decode_dispatches"]
    _log(f"slice: {len(states)} requests, {stats['tokens_generated']} "
         f"tokens, {n_pre} prefill and {n_dec} decode dispatches, "
         f"{stats['preemptions']} preemptions; launches {launches}")
    _require(launches["flash_attention_fwd"] >= L * n_pre > 0,
             f"flash launches {launches['flash_attention_fwd']} < "
             f"{L} x {n_pre} prefill dispatches")
    _require(launches["paged_decode_attention"] == L * n_dec > 0,
             f"paged-decode launches {launches['paged_decode_attention']}"
             f" != {L} x {n_dec} decode dispatches")

    # teacher-forced cross-check: a no-cache forward over prompt +
    # generated must pick every generated token, up to near-ties
    ties, checked, worst_gap = 0, 0, 0.0
    with torch.no_grad():
        for st in states:
            seq = np.concatenate([st.request.prompt,
                                  np.asarray(st.generated, np.int32)])
            ids = torch.from_numpy(seq[None].astype(np.int64)).cuda()
            logits = model(ids)[0].float()                     # [S, V]
            _require(bool(torch.isfinite(logits).all()),
                     "non-finite logits in the teacher-forced forward")
            P = st.prompt_len
            pred = logits[P - 1:-1]
            gen = torch.tensor(st.generated, device="cuda")
            gap = pred.max(-1).values - pred.gather(1, gen[:, None])[:, 0]
            miss = pred.argmax(-1) != gen
            checked += gen.numel()
            if bool(miss.any()):
                g = gap[miss]
                ties += int(miss.sum())
                worst_gap = max(worst_gap, float(g.max()))
    _log(f"slice: teacher-forced check over {checked} generated tokens: "
         f"{ties} positions pick another token, largest logit gap there "
         f"{worst_gap:.3e} (allowed < {TIE_GAP:g})")
    _require(worst_gap < TIE_GAP,
             f"teacher-forced forward disagrees with the engine by a logit"
             f" gap of {worst_gap} >= {TIE_GAP}")

    def ms(x):
        return "n/a" if x is None else f"{x * 1e3:.3f} ms"
    _log(f"slice: {summary['tokens_per_sec']:.2f} tokens/s, TTFT p50 "
         f"{ms(summary['ttft_p50_s'])} p99 {ms(summary['ttft_p99_s'])}, "
         f"decode step p50 {ms(summary['decode_step_p50_s'])} p99 "
         f"{ms(summary['decode_step_p99_s'])}, mean decode occupancy "
         f"{summary['mean_decode_occupancy']:.3f}, peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches


# -- main ---------------------------------------------------------------------
def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "paddle_tpu_torch", "csrc")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # full float32 products, as the JAX package's "highest" precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_card()
    rows = phase_kernels()
    launches = phase_slice()
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "paddle_tpu" or m.startswith("paddle_tpu."))
    _require(not leaked, f"the port imported {leaked[:5]}")

    from paddle_tpu_torch.ops import kernels
    line = []
    for k in kernels.kernels():
        r = rows[k["name"]]
        line.append({"name": k["name"], "route": "cuda",
                     "source": k["source"], "replaces": k["replaces"],
                     "launches": launches[k["name"]],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    _log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
