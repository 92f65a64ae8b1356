#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``paddle_tpu``, and it has no
fallback: any failure raises and the script exits non-zero without its
result line. Fourteen phases, in order:

1. card    -- print the card's name and power limit (``nvidia-smi``),
              build every kernel from ``paddle_tpu_torch/csrc`` with
              ``nvcc`` (one process per source, all at once);
2. kernels -- hold each kernel against its plain PyTorch version on the
              card at the serving, multi-tenant serving, GPT training,
              BERT and int8 inference paths' shapes, in float32 and
              bfloat16 (the int8 matmul bit-equal at its four shapes with
              a dynamic activation scale, its weight given K-major and as
              a contiguous [K, N]; the biased
              flash kernels also on a batch row with every key masked,
              bgmv also on rows of the zero adapter, which must be exactly
              0.0; the bf16 flash kernels, whose tensor-core products
              take pv (and in the backward ds) rounded to bf16 as the
              TPU kernels do, also against the plain versions that round
              the same operands), and time the kernel, the plain
              version, the card's bound and, where one exists, the one
              PyTorch call that computes the same function (the bf16
              flash kernels' and the f32 forward's earlier CUDA-core
              design's times and the paged-decode, int8 and bgmv
              kernels' first design's times printed beside them, with
              the redesigned kernels' registers and spills from the build
              log). The f32 forward, which runs three TF32 tensor-core
              products an f32 product, is timed at the serving prefill
              and at BERT-base's padded batch against SDPA in f32 and a
              bound at a third of the TF32 rate; bgmv at the decode and
              prefill dispatches; each redesigned kernel's two launches
              must give the same bits;
3. slice   -- serve 16 greedy requests on GPT-2 345M (random weights
              from a seed) through ``ServingEngine`` at the full serving
              configuration, check the launch counts against the
              dispatch counts and cross-check every generated token
              against a teacher-forced no-cache forward;
4. mt      -- multi-tenant serving of GPT-2 345M at the configuration of
              ``bench.py``'s ``serve_multitenant_metrics`` (full): int8
              paged KV, eight LoRA adapters of four tenants, at most four
              slots a tenant, 24 requests of its seeded traffic. The
              schedule is submitted at once and every generated token
              checked against a teacher-forced replay through the paged
              path with the plain versions (a one-slot int8 cache and the
              request's adapter); then exact launch counts (bgmv once per
              layer per dispatch, the quantized decode kernel once per
              layer per decode dispatch, the full-precision one never),
              every request completed, every adapter reference released;
              then the same traffic open-loop and timed, and the
              full-precision engine without LoRA on it as the bench's
              oracle;
5. parity  -- one float32 forward and backward of a 2-layer GPT-2 345M at
              full width with dropout, on the card and on the CPU from the
              same weights, batch and seed words: the CPU runs every
              kernel's plain version, so the loss and every gradient hold
              the card's kernels to them at full width;
6. amp     -- ten ``TrainStep`` steps of GPT-2 345M at the training
              configuration below, each held against the plain versions
              on the card: before every step the same loss and gradients
              are computed from the same parameters and seed words with
              every kernel wrapper swapped for its plain version (inside
              this script only; the flash ones round their products'
              bf16 operands as the kernels do, and a replay in float32
              is printed beside it); then ten float32 steps from the
              same weights, for comparison;
7. train   -- ten ``TrainStep`` steps of GPT-2 345M at the configuration
              of ``bench.py``'s ``bench_gpt2_345m`` (B=8, S=1024, AMP O1,
              dropout 0.1, AdamW), with exact launch counts per step,
              step time, tokens/s, peak memory, MFU and a profile of one
              more step;
8. bert parity -- phase 5 for a 2-layer BERT-base MLM at full width on a
              padded batch (row 1 padded to 300 of 512 positions);
9. bert witness -- phase 6's check for the first three O1 steps of the
              BERT path below;
10. bert   -- ten ``TrainStep`` steps of BERT-base MLM at ``bench.py``'s
              ``bench_bert_mlm`` configuration (B=48, S=512, 76 masked
              positions, AMP O1, AdamW) on a padded batch shaped like
              Google BERT's pretraining records, with exact launch counts,
              step time, tokens/s, peak memory, MFU and a profile;
11. ernie  -- three ERNIE-base pretraining steps (MLM + SOP) at
              ``bench_ernie``'s configuration on the same kind of batch,
              each held against the plain versions as in phase 9, with
              exact launch counts, then three timed steps;
12. predict -- BERT-base MLM inference on phase 10's padded batch
              through ``inference.create_predictor``: f32, ``enable_int8``,
              ``enable_int8`` + ``enable_tpu_bf16`` and static
              ``PostTrainingQuantization`` (two calibration batches)
              predictors, each with exact launch counts (74 int8 matmuls
              and 12 biased flash forwards a run, no shape fallback),
              each replayed with every plain version (the f32 one within
              1e-4 of its largest score, the quantized ones printed),
              the quantized ones also with int8_matmul's plain version
              (bit-equal), the first three timed (median of 10 runs after
              2), one f32 and one int8 run profiled, quality against f32
              printed;
13. amp_int8 -- three O1 ``TrainStep`` steps of phase 7's GPT-2 345M
              under ``FLAGS_amp_int8_matmul`` (its MLP linears through the
              int8 kernel, 48 a step), each held against int8_matmul's
              plain version and, as in phase 6, against every plain
              version;
14. summary -- print one JSON line describing every ported kernel, then
              the result line ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each of phases 3, 4, 7, 10, 11
and 13, and before each predictor of phase 12, and read just after
(a witness's reference runs are taken back out of them); the
kernel JSON line gives each kernel's launches per path (``serve``,
``mt``, ``train``, ``bert``, ``ernie``, ``predict``, ``amp_int8``). Each
phase prints its seconds, and the run its total.

Without a CUDA device, or in a directory that holds this script and
nothing else of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit;
# int8 in tensor-core operations a second). The f32 flash forward runs an
# f32 product as three TF32 tensor-core products (the 3xTF32 split, f32
# accuracy): its peak is a third of the 494.7 TFLOP/s TF32 rate; every
# other f32 row keeps the CUDA cores' 67
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
              "float32_3xtf32": 494.7e12 / 3}

# tolerances of kernel vs plain version at the serving shapes, max abs
# error
TOL = {
    # the kernel sums the same products in another order
    "float32": 1e-4,
    # both round o to bfloat16 from f32 sums in other orders; the
    # tensor-core kernel also rounds p.V's operand pv to bf16, as the TPU
    # kernels' MXU does (and the plain version with bf16 MXU operands)
    "bfloat16": 2e-2,
}
# flash forward and backward at the training shapes, max abs error
# relative to the reference's largest magnitude: in bf16 the two round
# o, dq, dk, dv from f32 values summed in other orders, so an element
# may differ by one bf16 ulp, at most 2^-7 of the largest (1.064e-03
# measured, on dk); f32 as TOL
TRAIN_FLASH_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the bf16 flash kernels' times at the same shapes when they ran their
# products on the CUDA cores in f32 (this script's last run of each
# design, on an H100 80GB HBM3 at 700 W); printed beside today's
CUDA_CORE_BWD_MS = {"flash_attention_bwd": 3.6618,
                    "flash_attention_bias_bwd_dq": 2.5911,
                    "flash_attention_bias_bwd_dkv": 3.5730}
CUDA_CORE_FWD_MS = {"flash_attention_fwd": 0.8267,
                    "flash_attention_bias_fwd": 1.5209}
# the float32 flash forward's times when it ran its products on the CUDA
# cores (flash_fwd_kernel<float>), at the f32 shapes timed below: the
# serving prefill, and BERT-base's padded batch without dropout (the f32
# and int8 predictors) and with rate 0.1 (tools/time_torch_flash_f32.py
# --also on the earlier source, an H100 80GB HBM3 at 700 W); printed
# beside today's
CUDA_CORE_F32_FWD_MS = {"flash_attention_fwd float32": 0.0530,
                        "flash_attention_bias_fwd float32": 1.4644,
                        "flash_attention_bias_fwd float32 dropout 0.1":
                            1.5340}
# the paged-decode kernels' and the int8 matmul's times at the same shapes
# in their first design (one block per (slot, head) walking its positions
# row by row; mma.sync fed by byte gathers from an N-major weight), this
# script's last run of it on an H100 80GB HBM3 at 700 W; printed beside
# today's
FIRST_DESIGN_MS = {"paged_decode_attention": 0.0278,
                   "paged_decode_attention_quant": 0.0481,
                   "int8_matmul": 0.1056,
                   # bgmv's first design (a block per (row, 16 tokens, 1024
                   # columns)) at its two dispatch shapes, float32: decode
                   # from this script's last run of it, prefill from
                   # tools/time_torch_bgmv_variants.py --also
                   "bgmv": 0.0122, "bgmv B=8 S=1 float32": 0.0122,
                   "bgmv B=4 S=256 float32": 0.0293}
# the redesigned kernels' entry functions, whose ptxas lines (registers,
# spills) phase 2 prints
PTXAS_ENTRIES = {"paged_decode_attention": "paged_decode_kernel",
                 "int8_matmul": "int8_matmul_kernel",
                 "flash_attention_fwd": "flash_fwd_f32_kernel",
                 "bgmv": "bgmv_kernel"}
# the lse kernel and its plain version sum 50304 exponentials in
# another order: relative to the largest lse
LSE_TOL = 1e-5
# dlogits, per element, from the same lse: |d - plain| <= DLOGITS_REL *
# (|plain| + DLOGITS_FLOOR * g) with g the row's upstream gradient. In
# f32 one exp differs in its last bits; in bf16 the two f32 values may
# round to neighbours, one bf16 ulp, at most 2^-7 of the value. Entries
# with p below a millionth count against that floor.
DLOGITS_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DLOGITS_FLOOR = 1e-6

# bgmv against its plain version, max abs error over max |plain|: f32
# sums the rank-8 shrink's 1024 products and the expand's 8 in other
# orders; in bf16 both round the same f32 value to the output, at most
# one bf16 ulp apart
BGMV_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

# the training path measured here is bench.py's bench_gpt2_345m
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 10
TRAIN_LR, TRAIN_WD = 1e-4, 0.01
# O1 steps, kernels against plain versions from the same parameters:
# the loss relative to the plain one, and the gradients' error norm
# relative to the plain gradients' norm over all parameters. Both paths
# round attention outputs and gradients to bf16 from sums in other
# orders, and 24 layers carry those roundings; measured on one H100:
# loss 8.0e-06, gradients 1.470e-02 at step 1 falling to 1.184e-03 at
# step 10
AMP_LOSS_TOL, AMP_GRAD_TOL = 1e-4, 3e-2
# ERNIE's loss adds the SOP term, a mean over only B=48 rows of a
# 2-class cross-entropy on bf16 logits. After the step-2 jump the logits
# reach |x| ~ 5, whose bf16 ulp is 2^-5; a one-ulp difference in each
# row's logits moves the mean by about 2 * 2^-5 / sqrt(48) ~ 9e-3, 6.5e-4
# of a loss near 13.8. Measured on one H100: 7.337e-05 at step 1 and
# 1.421e-04 at step 2, above AMP_LOSS_TOL, with the gradients within
# 1.153e-02 and 3.532e-03 of their norm
ERNIE_LOSS_TOL = 1e-3
# card-vs-CPU parity step: full width, 2 layers, float32
PARITY_LAYERS, PARITY_B, PARITY_S = 2, 2, 1024
# loss: relative; gradients: max abs error relative to each gradient's
# largest magnitude (sums of 2048 rows in another order, and the
# attention backward recomputing p in another order)
PARITY_LOSS_TOL, PARITY_GRAD_TOL = 1e-5, 1e-3

# the BERT and ERNIE paths: bench.py's bench_bert_mlm and bench_ernie
# configurations (B, S, masked positions M; AMP O1, AdamW 1e-4, decay
# 0.01) on a padded batch in the shape of Google BERT's pretraining
# records (create_pretraining_data.py: short_seq_prob 0.1, 15% masked)
BERT_B, BERT_S, BERT_M = 48, 512, 76
BERT_STEPS, BERT_WITNESS_STEPS, ERNIE_STEPS = 10, 3, 3
SHORT_SEQ_PROB, MASKED_LM_PROB = 0.1, 0.15
PAD, CLS, SEP, FIRST_ID = 0, 2, 3, 5
# card-vs-CPU BERT step: full width, 2 layers, f32, one row padded
BERT_PARITY_LAYERS, BERT_PARITY_B, BERT_PARITY_LEN = 2, 2, 300

# the serving path measured here is bench.py --serve at full width
SERVE_CFG = dict(max_batch_slots=8, block_size=16, max_context_len=512,
                 prefill_buckets=(128, 256), batch_buckets=(1, 2, 4))
NUM_REQUESTS = 16
PROMPT_RANGE = (64, 224)
NEW_TOKENS_RANGE = (16, 48)
# the multi-tenant path: bench.py's serve_multitenant_metrics (full, not
# quick) on SERVE_CFG: int8 paged KV, 4 tenants with 2 LoRA adapters of
# rank 8 each, at most 4 slots a tenant, and its seeded open-loop traffic
MT_TENANTS, MT_PER_TENANT, MT_RANK, MT_QUOTA = 4, 2, 8, 4
MT_SPEC = dict(num_requests=24, rate_rps=6.0, prompt_len_range=(16, 64),
               max_new_range=(8, 24), vocab_size=50304, seed=23,
               shared_prefix_len=32, prefix_pool_size=2, tenants=MT_TENANTS,
               adapter_pool=MT_PER_TENANT)
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
    every launch where the real caller finds the inputs cold in L2.
    Before each pair the card spins for about 0.1 ms, so the host has
    queued the launch before the start event is reached and a short
    kernel's time does not include the host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(200_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


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
    sources = {k.source: k.name for k in kernels.KERNELS.values()}
    _log(f"card: built {len(kernels.KERNELS)} kernels from {len(sources)} "
         f"sources in {secs:.2f} s")
    for source, name in sources.items():
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {source}: {line.strip()}")
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
    again = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    torch.cuda.synchronize()
    _require(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
             "two launches of flash_attention_fwd gave different bits")
    err = _abs_err(o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    name = str(dtype).replace("torch.", "")
    mxu = _mxu_errs((o,), lambda: (flash_attention_plain(
        q, k, v, causal=True, mxu_dtype=torch.bfloat16),), dtype,
        _abs_err)
    _log(f"kernels: flash_attention_fwd B={B} S={S} H={H} D={D} {name} "
         f"causal: max|o-plain| {err:.3e}, max|lse-plain| {lse_err:.3e} "
         f"(tol {TOL[name]:g})" + _mxu_note(mxu, ("max|o-plain|",)))
    _require(math.isfinite(err) and max([err] + mxu) <= TOL[name],
             f"flash_attention_fwd disagrees with its plain versions "
             f"({err}, against bf16 MXU operands {mxu}; tol {TOL[name]}) "
             f"at S={S} {name}")
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
    # f32 runs three TF32 tensor-core products an f32 product
    bound, by = _bound_ms(nbytes, flops, "float32_3xtf32"
                          if name == "float32" else name)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "shape": f"B={B} S={S} H={H} D={D} {name} causal"}


def _f32_bias_fwd_case(mask, rate):
    """The f32 biased forward at BERT-base's padded batch, as the f32 and
    int8 predictors run it (rate 0) and as f32 training would (rate
    0.1), the f32 -1e30 key bias: o within TOL["float32"] of the plain
    version, two launches bit-equal; timed beside SDPA in f32 with the
    float mask, against the 3xTF32 bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, S, H, D = BERT_B, BERT_S, 12, 64
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
               for _ in range(3))
    bias = _key_bias(mask, torch.float32)
    args = (False, None, True, rate, (0x0BADF00D, 0x5EED5EED))
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, *args)
    again = fa.flash_attention_bias_fwd(q, k, v, bias, *args)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, *args, bias)
    err = _abs_err(o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    equal = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    del o_ref, lse_ref, again
    shape = (f"B={B} S={S} H={H} D={D} float32 key bias "
             f"({int((mask == 0).any(1).sum())} padded rows) dropout {rate}")
    _log(f"kernels: flash_attention_bias_fwd [{shape}]: max|o-plain| "
         f"{err:.3e}, max|lse-plain| {lse_err:.3e} (tol "
         f"{TOL['float32']:g}); two launches bit-equal {equal}")
    _require(err <= TOL["float32"] and lse_err <= TOL["float32"] * 10,
             f"the f32 biased forward disagrees with its plain version "
             f"({err}, lse {lse_err})")
    _require(equal, "two launches of the f32 biased forward differ")
    ms = _median_ms(lambda: fa.flash_attention_bias_fwd(q, k, v, bias,
                                                        *args))
    plain_ms = _median_ms(lambda: fa.flash_attention_plain(q, k, v, *args,
                                                           bias),
                          iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias[:, None, None, :], dropout_p=rate))
    pairs = H * S * int(mask.sum())         # every row sees its row's keys
    bound, by = _bound_ms(4 * B * S * H * D * 4 + B * S * 4 + B * H * S * 4,
                          4 * D * pairs, "float32_3xtf32")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "shape": shape}


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


def _quant_paged_case(seed, timed=False):
    """Kernel 10 at row 9's shape: float32 q, int8 pools written by
    ``write_pages_quant`` from random float32 K/V, an inactive slot."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention_quant, paged_decode_quant_plain)
    from paddle_tpu_torch.serving.kv_cache import write_pages_quant
    B, MB, bs, H, D, P = 8, 32, 16, 16, 64, 257
    g = torch.Generator(device="cuda").manual_seed(seed)
    every_page = torch.arange(P, dtype=torch.int32, device="cuda")[None]
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    pools = []
    for _ in range(2):
        pages = torch.zeros(P, bs, H, D, dtype=torch.int8, device="cuda")
        scales = torch.zeros(P, bs, H, device="cuda")
        write_pages_quant(pages, scales, torch.randn(
            1, P * bs, H, D, device="cuda", generator=g), every_page, start)
        pools.append((pages, scales))
    (kp, ks), (vp, vs) = pools
    q = torch.randn(B, H, D, device="cuda", generator=g)
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
    args = (q, kp, ks, vp, vs, tbl, pos_t, 1.0 / math.sqrt(D))
    out = paged_decode_attention_quant(*args)
    ref = paged_decode_quant_plain(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    _log(f"kernels: paged_decode_attention_quant B={B} MB={MB} bs={bs} "
         f"H={H} D={D} P={P} int8 pools, float32 q, pos={pos.tolist()}: "
         f"max|o-plain| {err:.3e} (tol {TOL['float32']:g})")
    _require(math.isfinite(err) and err <= TOL["float32"],
             f"paged_decode_attention_quant disagrees with its plain "
             f"version ({err} > {TOL['float32']})")
    if not timed:
        return None
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = _median_ms(lambda: paged_decode_attention_quant(*args),
                    flush=scrub.zero_)
    plain_ms = _median_ms(lambda: paged_decode_quant_plain(*args),
                          flush=scrub.zero_)
    visible = int((np.minimum(pos, MB * bs - 1).astype(np.int64) + 1).sum())
    nbytes = (visible * H * (D + 4) * 2       # int8 K and V rows, scales
              + 2 * B * H * D * 4             # q read, out written
              + table.nbytes + pos.nbytes)
    bound, by = _bound_ms(nbytes, 4 * H * D * visible, "float32")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"B={B} MB={MB} bs={bs} H={H} D={D} P={P} int8, "
                     f"{visible} visible positions"}


def _bgmv_case(B, S, dtype, ids, timed=False):
    """Kernel 11 at a serving dispatch's shape (E=1024, r=8, O=3072,
    float32 pools of 8 adapters and the zero row); rows with id 0 must
    be exactly 0.0."""
    import torch
    from paddle_tpu_torch.ops.kernels.bgmv import bgmv, bgmv_plain
    E, r, O, A = 1024, 8, 3072, 9
    g = torch.Generator(device="cuda").manual_seed(31 + S)
    x = torch.randn(B, S, E, device="cuda", generator=g).to(dtype)
    a = torch.randn(A, r, E, device="cuda", generator=g)
    b = torch.randn(A, r, O, device="cuda", generator=g)
    a[0] = 0.0
    b[0] = 0.0
    ids_t = torch.tensor(ids, dtype=torch.int32, device="cuda")
    out = bgmv(x, a, b, ids_t)
    again = bgmv(x, a, b, ids_t)
    ref = bgmv_plain(x, a, b, ids_t)
    torch.cuda.synchronize()
    name = _name(dtype)
    err = _rel_err(out, ref)
    zero = [i for i, k in enumerate(ids) if k == 0]
    exact = bool((out[zero] == 0).all()) and \
        not bool(out[zero].signbit().any())
    equal = torch.equal(out, again)
    _log(f"kernels: bgmv B={B} S={S} E={E} r={r} O={O} {name} ids={ids}: "
         f"max|d-plain|/max|plain| {err:.3e} (tol "
         f"{BGMV_TOL[name]:g}); zero-adapter rows {zero} exactly +0.0: "
         f"{exact}; two launches bit-equal {equal}")
    _require(math.isfinite(err) and err <= BGMV_TOL[name],
             f"bgmv disagrees with its plain version ({err}) at B={B} "
             f"S={S} {name}")
    _require(exact, f"bgmv rows {zero} on the zero adapter are not +0.0")
    _require(equal, "two launches of bgmv gave different bits")
    if not timed:
        return None
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = _median_ms(lambda: bgmv(x, a, b, ids_t), flush=scrub.zero_)
    plain_ms = _median_ms(lambda: bgmv_plain(x, a, b, ids_t),
                          flush=scrub.zero_)
    rows = len(set(ids))                      # the adapter rows gathered
    nbytes = (x.numel() * x.element_size() + B * S * O * x.element_size()
              + rows * r * (E + O) * a.element_size() + 4 * B)
    bound, by = _bound_ms(nbytes, 2 * B * S * r * (E + O), name)
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "shape": f"B={B} S={S} E={E} r={r} O={O} {name}, "
                     f"{rows} adapter rows"}


def _dropout_case(dtype, timed=False):
    """Bit-equal to the plain version at the residual stream's shape."""
    import torch
    from paddle_tpu_torch.ops.kernels.dropout import (dropout_apply,
                                                      dropout_plain)
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(TRAIN_B, TRAIN_S, 1024, device="cuda",
                    generator=g).to(dtype)
    words = (0x12345678, 0x9ABCDEF0)
    y = dropout_apply(x, 0.1, words)
    equal = torch.equal(y, dropout_plain(x, 0.1, words))
    kept = (y != 0).float().mean().item()
    _log(f"kernels: fused_dropout {tuple(x.shape)} {_name(dtype)} rate 0.1: "
         f"bit-equal to plain {equal}, kept {kept:.5f}")
    _require(equal, f"fused_dropout differs from its plain version in "
             f"{_name(dtype)}")
    if not timed:
        return None
    ms = _median_ms(lambda: dropout_apply(x, 0.1, words))
    plain_ms = _median_ms(lambda: dropout_plain(x, 0.1, words), iters=10)
    lib_ms = _median_ms(lambda: torch.nn.functional.dropout(x, 0.1, True))
    bound, by = _bound_ms(2 * x.numel() * x.element_size(), 0, "float32")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "shape": f"{tuple(x.shape)} {_name(dtype)}"}


def _ce_case(dtype, timed=False):
    """lse and dlogits at the LM head's [B*S, V] against the plain
    versions; returns the two rows when timed."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import chunked_ce as ce
    N, V = TRAIN_B * TRAIN_S, 50304
    g = torch.Generator(device="cuda").manual_seed(6)
    logits = (torch.randn(N, V, device="cuda", generator=g) * 2).to(dtype)
    labels = torch.randint(0, V, (N,), device="cuda", generator=g,
                           dtype=torch.int32)
    gr = torch.full((N,), 1.0 / N, device="cuda")
    lse = ce.online_lse(logits)
    lse_ref = ce.online_lse_plain(logits)
    lse_err = (lse - lse_ref).abs().max().item()
    d = ce.dlogits(logits, labels, lse_ref, gr).float()
    d_ref = ce.dlogits_plain(logits, labels, lse_ref, gr).float()
    diff = (d - d_ref).abs_()
    d_err = diff.max().item()
    d_rel = diff.div_(d_ref.abs_().add_(DLOGITS_FLOOR * gr[:, None])) \
        .max().item()
    del d, d_ref, diff
    tol = DLOGITS_REL[_name(dtype)]
    _log(f"kernels: chunked_ce N={N} V={V} {_name(dtype)}: max|lse-plain| "
         f"{lse_err:.3e} (tol {LSE_TOL * lse_ref.abs().max().item():.3e}), "
         f"dlogits max |d-plain|/(|plain|+{DLOGITS_FLOOR:g}g) {d_rel:.3e} "
         f"(tol {tol:.3e}), max|d-plain| {d_err:.3e}")
    _require(lse_err <= LSE_TOL * lse_ref.abs().max().item(),
             f"chunked_ce_lse disagrees with its plain version ({lse_err})")
    _require(d_rel <= tol, f"chunked_ce_dlogits disagrees with its plain "
             f"version ({d_rel} > {tol} per element)")
    if not timed:
        return None
    elem = logits.element_size()
    lg = logits.detach().requires_grad_()
    lab64 = labels.long()
    lib_lse = _median_ms(lambda: F.cross_entropy(lg.detach(), lab64,
                                                 reduction="none"))
    out = F.cross_entropy(lg, lab64, reduction="none")
    # autograd.grad: the backward alone, with no accumulation into .grad
    lib_d = _median_ms(lambda: torch.autograd.grad(out, lg, gr,
                                                   retain_graph=True))
    b_lse, by_lse = _bound_ms(N * V * elem + N * 4, 0, "float32")
    b_d, by_d = _bound_ms(2 * N * V * elem + N * 12, 0, "float32")
    shape = f"N={N} V={V} {_name(dtype)}"
    return {
        "chunked_ce_lse": {
            "max_abs_err": lse_err, "bound_ms": b_lse, "bound_by": by_lse,
            "ms": _median_ms(lambda: ce.online_lse(logits)),
            "plain_ms": _median_ms(lambda: ce.online_lse_plain(logits),
                                   iters=10),
            "library_ms": lib_lse, "shape": shape},
        "chunked_ce_dlogits": {
            "max_abs_err": d_err, "bound_ms": b_d, "bound_by": by_d,
            "ms": _median_ms(lambda: ce.dlogits(logits, labels, lse, gr)),
            "plain_ms": _median_ms(lambda: ce.dlogits_plain(
                logits, labels, lse, gr), iters=10),
            "library_ms": lib_d, "shape": shape}}


def _abs_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def _mxu_errs(outs, plain_mxu, dtype, err=_rel_err) -> list:
    """In bfloat16 the flash kernels round pv (and in the backward ds) to
    bf16 before their second products, as the TPU kernels' ``_dot`` does
    under the default precision policy: each output's ``err`` (max abs
    error / max |plain| unless said) against the plain version that
    rounds the same operands (``plain_mxu()``); in float32 nothing (no
    such rounding)."""
    import torch
    if dtype != torch.bfloat16:
        return []
    return [err(a, r) for a, r in zip(outs, plain_mxu())]


def _mxu_note(errs: list, names) -> str:
    if not errs:
        return ""
    return ("; against the plain version with bf16 MXU operands " + ", ".join(
        f"{n} {e:.3e}" for n, e in zip(names, errs)))


def _flash_train_case(dtype, timed=False):
    """Forward with dropout and backward at the training shapes, against
    the plain versions; the backward's is fed the kernel's o and lse, so
    only the order of summation and the output rounding differ."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)
    B, S, H, D, rate = TRAIN_B, TRAIN_S, 16, 64, 0.1
    words = (0x2468ACE0, 0x13579BDF)
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    name = _name(dtype)
    o, lse = flash_attention_fwd(q, k, v, True, None, True, rate, words)
    o_err = _rel_err(o, flash_attention_plain(q, k, v, True, None, False,
                                              rate, words))
    grads = flash_attention_bwd(q, k, v, o, lse, do, True, None, rate, words)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, True, None, rate,
                                     words)
    errs = [_rel_err(a, r) for a, r in zip(grads, refs)]
    mxu = _mxu_errs((o,), lambda: (flash_attention_plain(
        q, k, v, True, None, False, rate, words,
        mxu_dtype=torch.bfloat16),), dtype)
    mxu += _mxu_errs(grads, lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, True, None, rate, words,
        mxu_dtype=torch.bfloat16), dtype)
    _log(f"kernels: flash B={B} S={S} H={H} D={D} {name} causal dropout "
         f"{rate}: o {o_err:.3e}, dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
         f"dv {errs[2]:.3e} (max abs error / max |plain|, tol "
         f"{TRAIN_FLASH_TOL[name]:g})"
         + _mxu_note(mxu, ("o", "dq", "dk", "dv")))
    _require(max([o_err] + errs + mxu) <= TRAIN_FLASH_TOL[name],
             f"flash forward/backward with dropout disagree with their "
             f"plain versions in {name}: o {o_err}, grads {errs}, against "
             f"bf16 MXU operands {mxu}")
    del grads, refs
    if not timed:
        return None
    pairs = S * (S + 1) // 2
    elem = q.element_size()
    fwd_ms = _median_ms(lambda: flash_attention_fwd(q, k, v, True, None,
                                                    True, rate, words))
    fwd_plain = _median_ms(lambda: flash_attention_plain(
        q, k, v, True, None, True, rate, words), iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd_lib = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, dropout_p=rate, is_causal=True))
    b_fwd, by_fwd = _bound_ms(4 * B * S * H * D * elem + B * H * S * 4,
                              4 * B * H * D * pairs, name)
    bwd_ms = _median_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                    True, None, rate, words))
    bwd_plain = _median_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, True, None, rate, words), iters=5, warmup=1)
    ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=rate,
                                         is_causal=True)
    dot = do.transpose(1, 2)
    bwd_lib = _median_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), dot, retain_graph=True))
    # q, k, v, o, dO read and dq, dk, dv written; lse read
    b_bwd, by_bwd = _bound_ms(8 * B * S * H * D * elem + B * H * S * 4,
                              10 * B * H * D * pairs, name)
    shape = f"B={B} S={S} H={H} D={D} {name} causal dropout {rate}"
    return {
        "flash_attention_fwd": {
            "max_abs_err": o_err, "ms": fwd_ms, "plain_ms": fwd_plain,
            "bound_ms": b_fwd, "bound_by": by_fwd, "library_ms": fwd_lib,
            "shape": shape},
        "flash_attention_bwd": {
            "max_abs_err": max(errs), "ms": bwd_ms, "plain_ms": bwd_plain,
            "bound_ms": b_bwd, "bound_by": by_bwd, "library_ms": bwd_lib,
            "shape": shape}}


def pretraining_batch(B, S, M, V, seed=0, lengths=None):
    """A padded MLM batch from ``np.random.default_rng(seed)``, in the
    shape of Google BERT's pretraining records: a row holds ``[CLS]``,
    ids from ``[FIRST_ID, V)`` with ``[SEP]`` at a split point and at its
    last position, then ``[PAD]``; 90% of rows are ``S`` long and the
    rest (``SHORT_SEQ_PROB``) draw a length from [8, S], unless
    ``lengths`` gives them. Token types are 1 after the first ``[SEP]``
    and below the length; n = min(M, max(1, round(0.15 L))) non-special
    positions are masked, the ``M - n`` padding slots have position 0,
    label 0 and weight 0. Returns ``(ids, token_types, attention_mask,
    positions, labels, weights)`` and the SOP labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = np.full((B, S), PAD, np.int32)
    tt = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), np.int32)
    pos = np.zeros((B, M), np.int32)
    labels = np.zeros((B, M), np.int32)
    w = np.zeros((B, M), np.float32)
    for b in range(B):
        if lengths is not None:
            L = int(lengths[b])
        elif rng.random() < SHORT_SEQ_PROB:
            L = int(rng.integers(8, S + 1))
        else:
            L = S
        split = int(rng.integers(1, L - 1))
        ids[b, :L] = rng.integers(FIRST_ID, V, L)
        ids[b, [0, split, L - 1]] = CLS, SEP, SEP
        tt[b, split + 1:L] = 1
        mask[b, :L] = 1
        n = min(M, max(1, round(MASKED_LM_PROB * L)))
        cand = np.setdiff1d(np.arange(1, L - 1), [split])
        pos[b, :n] = rng.choice(cand, n, replace=False)
        labels[b, :n] = rng.integers(FIRST_ID, V, n)
        w[b, :n] = 1.0
    sop = rng.integers(0, 2, B).astype(np.int32)
    return (ids, tt, mask, pos, labels, w), sop


def _key_bias(mask, dtype):
    """The additive key bias ``[B, S]`` float32 a BERT mask reaches the
    kernels as: ``(1 - m) * -1e30``, rounded to bf16 first under O1."""
    import torch
    bias = (1.0 - torch.from_numpy(mask).float()) * -1e30
    return bias.to(dtype).float().cuda()


def _bias_flash_case(B, S, H, D, dtype, mask, rate=0.1, seed=10,
                     timed=False, full_row=None):
    """The biased forward with dropout and its dq and dk/dv/dbias
    kernels against their plain versions (the backward's fed the
    kernel's o and lse); with ``full_row`` that batch row is fully
    masked and must give o = 0 and lse = -1e30."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    words = (0x0BADF00D, 0x5EED5EED)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    bias = _key_bias(mask, dtype)
    name = _name(dtype)
    args = (False, None, rate, words)
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, False, None, True,
                                         rate, words)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, False, None, True,
                                              rate, words, bias)
    errs = {"o": _rel_err(o, o_ref)}
    lse_err = (lse - lse_ref).abs().max().item()
    mxu = _mxu_errs((o,), lambda: (fa.flash_attention_plain(
        q, k, v, False, None, False, rate, words, bias,
        mxu_dtype=torch.bfloat16),), dtype)
    dq = fa.flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args)
    dk, dv, db = fa.flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                                 *args)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                        bias=bias)
    errs.update((n, _rel_err(a, r)) for n, a, r in
                zip(("dq", "dk", "dv", "db"), (dq, dk, dv, db), refs))
    del refs
    mxu += _mxu_errs((dq, dk, dv), lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, *args, bias=bias,
        mxu_dtype=torch.bfloat16)[:3], dtype)
    tol = TRAIN_FLASH_TOL[name]
    shape = (f"B={B} S={S} H={H} D={D} {name} key bias "
             f"({int((mask == 0).any(1).sum())} padded rows) dropout {rate}")
    _log(f"kernels: flash bias [{shape}]: " + ", ".join(
        f"{n} {e:.3e}" for n, e in errs.items())
        + f" (max abs error / max |plain|, tol {tol:g}; db f32 tol "
        f"{TRAIN_FLASH_TOL['float32']:g}), max|lse-plain| {lse_err:.3e}"
        + _mxu_note(mxu, ("o", "dq", "dk", "dv")))
    _require(max([e for n, e in errs.items() if n != "db"] + mxu) <= tol
             and errs["db"] <= TRAIN_FLASH_TOL["float32"]
             and lse_err <= TOL["float32"] * 10,
             f"biased flash kernels disagree with their plain versions in "
             f"{name}: {errs}, lse {lse_err}, against bf16 MXU operands "
             f"{mxu}")
    if full_row is not None:
        zero = bool((o[full_row] == 0).all()) and \
            bool((lse[full_row] == -1e30).all())
        _log(f"kernels: fully masked row {full_row} with the {name}-rounded "
             f"-1e30 bias: o == 0 and lse == -1e30: {zero}")
        _require(zero, "a fully masked row did not give o = 0, "
                 "lse = -1e30")
    del dq, dk, dv, db
    if not timed:
        return None
    elem = q.element_size()
    # the pairs this data needs: every query row sees its row's keys
    pairs = H * S * int(mask.sum())
    io = B * S * H * D * elem
    row_f32 = B * S * 4                          # a bias or db row
    b_fwd = _bound_ms(4 * io + row_f32 + B * H * S * 4, 4 * D * pairs, name)
    b_dq = _bound_ms(6 * io + row_f32 + B * H * S * 4, 6 * D * pairs, name)
    b_dkv = _bound_ms(7 * io + 2 * row_f32 + B * H * S * 4, 8 * D * pairs,
                      name)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_mask = bias.to(dtype)[:, None, None, :]
    fwd_lib = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=lib_mask, dropout_p=rate))
    ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask,
                                         dropout_p=rate)
    bwd_lib = _median_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do.transpose(1, 2), retain_graph=True))
    rows = {
        "flash_attention_bias_fwd": (
            errs["o"], b_fwd, fwd_lib,
            lambda: fa.flash_attention_bias_fwd(q, k, v, bias, False, None,
                                                True, rate, words),
            lambda: fa.flash_attention_plain(q, k, v, False, None, True,
                                             rate, words, bias)),
        "flash_attention_bias_bwd_dq": (
            errs["dq"], b_dq, bwd_lib,
            lambda: fa.flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do,
                                                   *args),
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                                 bias=bias)),
        "flash_attention_bias_bwd_dkv": (
            max(errs["dk"], errs["dv"], errs["db"]), b_dkv, bwd_lib,
            lambda: fa.flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse,
                                                    do, *args),
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                                 bias=bias))}
    out_rows = {}
    for kname, (err, (bound, by), lib, kern, plain) in rows.items():
        out_rows[kname] = {
            "max_abs_err": err, "ms": _median_ms(kern),
            "plain_ms": _median_ms(plain, iters=5, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "shape": shape}
    return out_rows


# the int8 predictor's shapes (M, K, N): q/k/v/out and transform,
# linear1, linear2 at B*S = 24576 rows, and the pooler's 48 rows
INT8_SHAPES = ((BERT_B * BERT_S, 768, 768), (BERT_B * BERT_S, 768, 3072),
               (BERT_B * BERT_S, 3072, 768), (BERT_B, 768, 768))


def _int8_matmul_case(M, K, N, dtype):
    """Kernel 12 on activations quantized on the card with their
    dynamic absmax (a device scalar) and per-channel weights, as
    ``slim.QuantizedLinear`` feeds it (the weight K-major: the transposed
    view of a contiguous [N, K]; also given as a contiguous [K, N], which
    the wrapper copies K-major): equal to the plain version bit for bit.
    The kernel is timed on the K-major view. ``library_ms`` is
    ``torch._int_mm`` plus the epilogue multiply, two calls."""
    import torch
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    x_q, a_s = qm.quantize_per_tensor(
        torch.randn(M, K, device="cuda", generator=g))
    w_q, w_s = qm.quantize_per_channel(
        torch.randn(K, N, device="cuda", generator=g) * 0.02)
    w_k = w_q.t().contiguous().t()
    out = qm.int8_matmul(x_q, w_k, w_s, a_s, out_dtype=dtype)
    out_copied = qm.int8_matmul(x_q, w_q, w_s, a_s, out_dtype=dtype)
    ref = qm.int8_matmul_plain(x_q, w_q, w_s, a_s, out_dtype=dtype)
    torch.cuda.synchronize()
    err = max((o.float() - ref.float()).abs().max().item()
              for o in (out, out_copied))
    equal = torch.equal(out, ref) and torch.equal(out_copied, ref)
    name = _name(dtype)
    shape = f"M={M} K={K} N={N} {name} out, dynamic act_scale"
    _log(f"kernels: int8_matmul [{shape}], w_q K-major and contiguous: "
         f"bit-equal to plain {equal}, max|out-plain| {err:.3e} (must be 0)")
    _require(equal, f"int8_matmul differs from its plain version at {shape}")
    ms = _median_ms(lambda: qm.int8_matmul(x_q, w_k, w_s, a_s, dtype))
    plain_ms = _median_ms(lambda: qm.int8_matmul_plain(x_q, w_q, w_s, a_s,
                                                       dtype), iters=10)
    scale = a_s * w_s
    lib = torch.mul(torch._int_mm(x_q, w_q), scale).to(dtype)
    _log(f"kernels: torch._int_mm + epilogue equals the kernel: "
         f"{torch.equal(lib, out)}")
    lib_ms = _median_ms(lambda: torch.mul(torch._int_mm(x_q, w_q),
                                          scale).to(dtype))
    out_bytes = torch.empty((), dtype=dtype).element_size()
    bound, by = _bound_ms(M * K + K * N + 4 * N + 4 + M * N * out_bytes,
                          2 * M * K * N, "int8")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "shape": shape}


def phase_kernels() -> dict:
    import torch
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S in (128, 200):
            _flash_case(4, S, 16, 64, dtype, seed=S)
    _flash_case(2, 256, 8, 128, torch.float32, seed=3)
    _flash_case(4, 256, 16, 64, torch.bfloat16, seed=256)
    # the serving path runs float32 (the engine's cache dtype)
    serve_flash = _flash_case(4, 256, 16, 64, torch.float32, seed=256,
                              timed=True)
    f32_rows = {"flash_attention_fwd float32": serve_flash}
    _paged_case(torch.bfloat16, seed=1)
    rows["paged_decode_attention"] = _paged_case(torch.float32, seed=1,
                                                 timed=True)
    # the multi-tenant path: int8 decode, and bgmv at the decode (B=8,
    # S=1) and prefill (B=4, S=256) dispatches; its row times decode
    rows["paged_decode_attention_quant"] = _quant_paged_case(2, timed=True)
    bgmv_cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, ids in ((8, 1, [0, 1, 2, 3, 0, 5, 8, 8]),
                          (4, 256, [3, 0, 7, 3])):
            bgmv_cases[f"bgmv B={B} S={S} {_name(dtype)}"] = _bgmv_case(
                B, S, dtype, ids, timed=True)
    rows["bgmv"] = bgmv_cases["bgmv B=8 S=1 float32"]
    # the training path runs AMP O1: bf16 attention and logits, dropout
    # on bf16 and f32 activations; the rows time the bf16 case
    _flash_train_case(torch.float32)
    rows.update(_flash_train_case(torch.bfloat16, timed=True))
    _ce_case(torch.float32)
    rows.update(_ce_case(torch.bfloat16, timed=True))
    _dropout_case(torch.float32)
    rows["fused_dropout"] = _dropout_case(torch.bfloat16, timed=True)
    # the BERT path: its padded mask at the full shape, f32 and bf16 (the
    # O1 path's, timed); a small batch with a fully masked row, once
    # with the f32 -1e30 and once with the bf16-rounded one
    import numpy as np
    mask = pretraining_batch(BERT_B, BERT_S, BERT_M, 30528)[0][2]
    _require((mask == 0).any(), "the BERT batch has no padded row")
    _bias_flash_case(BERT_B, BERT_S, 12, 64, torch.float32, mask)
    # the f32 and int8 predictors' attention (and f32 training's, rate 0.1)
    for rate in (0.0, 0.1):
        f32_rows["flash_attention_bias_fwd float32"
                 + (f" dropout {rate}" if rate else "")] = \
            _f32_bias_fwd_case(mask, rate)
    torch.cuda.empty_cache()
    rows.update(_bias_flash_case(BERT_B, BERT_S, 12, 64, torch.bfloat16,
                                 mask, timed=True))
    small = np.ones((3, 200), np.int32)
    small[1, 77:] = 0
    small[2] = 0
    for dtype in (torch.float32, torch.bfloat16):
        _bias_flash_case(3, 200, 4, 64, dtype, small, seed=11, full_row=2)
    torch.cuda.empty_cache()
    # the int8 predictor's four shapes, float32 (predictor b) and bf16
    # (predictor c) out; the row is the most launched shape in float32
    int8_cases = {}
    for M, K, N in INT8_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            int8_cases[f"int8_matmul M={M} K={K} N={N} {_name(dtype)}"] = \
                _int8_matmul_case(M, K, N, dtype)
    rows["int8_matmul"] = int8_cases[
        f"int8_matmul M={BERT_B * BERT_S} K=768 N=768 float32"]
    torch.cuda.empty_cache()
    for name, r in {**rows, **f32_rows, **bgmv_cases, **int8_cases}.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        cuda_core = {**CUDA_CORE_FWD_MS, **CUDA_CORE_BWD_MS,
                     **CUDA_CORE_F32_FWD_MS}
        old = (f", the earlier CUDA-core design {cuda_core[name]:.4f} ms"
               if name in cuda_core else "")
        if name in FIRST_DESIGN_MS:
            old = f", the first design {FIRST_DESIGN_MS[name]:.4f} ms"
        _log(f"kernels: {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}), library {lib} ms{old}")
    for name, entry in PTXAS_ENTRIES.items():
        for line in _ptxas(name, entry):
            _log(f"kernels: ptxas {line}")
    return rows


def _ptxas(name: str, entry: str) -> list:
    """The ``-Xptxas -v`` registers and spills of each instantiation of
    the entry function ``entry`` in kernel ``name``'s build log (mangled
    template arguments as ptxas prints them)."""
    from paddle_tpu_torch.ops import kernels
    out, current = [], None
    for line in kernels.build_log(name).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
            current = fn[fn.index(entry):] if entry in fn else None
        elif current and ("spill" in line or "registers" in line):
            out.append(f"{current}: {line.split(':', 1)[-1].strip()}")
    return out


# -- phase 3 -----------------------------------------------------------------
def phase_slice() -> dict:
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (Request, SamplingParams,
                                          ServingConfig, ServingEngine)
    cfg = gpt2_medium()
    torch.cuda.reset_peak_memory_stats()
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


# -- phase 4: multi-tenant serving -------------------------------------------
def _mt_engine(model, multitenant: bool):
    """The engine of ``serve_multitenant_metrics``: int8 KV, the LoRA
    pools with every adapter the traffic names (bench.py:1133-1142) and
    the tenant quota; or, with ``multitenant`` False, its full-precision
    oracle without LoRA."""
    import numpy as np
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    if not multitenant:
        return ServingEngine(model, ServingConfig(**SERVE_CFG),
                             device="cuda")
    cfg = ServingConfig(**SERVE_CFG, lora_adapters=MT_TENANTS * MT_PER_TENANT,
                        lora_rank=MT_RANK, tenant_quota=MT_QUOTA)
    with flag_scope("serve_kv_quant", "int8"):
        eng = ServingEngine(model, cfg, device="cuda")
    wrng = np.random.default_rng(31)
    L, E = model.cfg.num_layers, model.cfg.hidden_size
    O = 3 * E
    for t in range(MT_TENANTS):
        for k in range(MT_PER_TENANT):
            eng.lora.load_adapter(
                f"tenant{t}/adapter{k}",
                weights=(wrng.standard_normal((L, MT_RANK, E))
                         .astype(np.float32) * 1e-3,
                         wrng.standard_normal((L, MT_RANK, O))
                         .astype(np.float32) * 1e-3))
    return eng


def _mt_replay(model, engine, states) -> None:
    """Teacher-forced replay of every request through the paged path
    with the plain versions: a one-slot int8 cache and the request's
    adapter row, the prompt prefilled at the engine's length bucket,
    then one S=1 decode step for each generated token but the last,
    feeding the engine's tokens. Every generated token must be the
    replay's argmax or within ``TIE_GAP`` of its largest logit."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import PagedCacheView, PagedKVCache
    cfg, ec = model.cfg, engine.cache
    with flag_scope("serve_kv_quant", "int8"):
        cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.head_dim,
            num_pages=1 + ec.max_blocks_per_slot, block_size=ec.block_size,
            max_slots=1, max_blocks_per_slot=ec.max_blocks_per_slot,
            device="cuda")
    before = sum(k["launches"] for k in kernels.kernels())
    ties, checked, worst_gap = 0, 0, 0.0
    with torch.no_grad(), _plain_versions():
        for st in states:
            prompt, gen = st.request.prompt, st.generated
            P = prompt.size
            _require(cache.alloc_slot(0, P + len(gen)), "replay cache full")
            view = PagedCacheView(
                cache.k, cache.v, cache.table_array([0]), cache.k_scale,
                cache.v_scale, engine.lora.a, engine.lora.b,
                engine.lora.rows_for([st.request.adapter]))
            ids = np.zeros((1, engine.buckets.len_bucket(P)), np.int64)
            ids[0, :P] = prompt
            zero = torch.zeros(1, dtype=torch.int32, device="cuda")
            preds = [model(torch.from_numpy(ids).cuda(), caches=view,
                           cache_pos=zero)[0, P - 1]]
            for i, tok in enumerate(gen[:-1]):
                pos = torch.tensor([P + i], dtype=torch.int32,
                                   device="cuda")
                preds.append(model(torch.tensor([[tok]], device="cuda"),
                                   caches=view, cache_pos=pos)[0, 0])
            cache.free_slot(0)
            pred = torch.stack(preds).float()
            _require(bool(torch.isfinite(pred).all()),
                     "non-finite logits in the teacher-forced replay")
            g = torch.tensor(gen, device="cuda")
            gap = pred.max(-1).values - pred.gather(1, g[:, None])[:, 0]
            miss = pred.argmax(-1) != g
            checked += g.numel()
            if bool(miss.any()):
                ties += int(miss.sum())
                worst_gap = max(worst_gap, float(gap[miss].max()))
    _require(sum(k["launches"] for k in kernels.kernels()) == before,
             "the plain replay launched a kernel")
    _log(f"mt: teacher-forced replay (plain versions, one-slot int8 "
         f"cache, each request's adapter) over {checked} generated "
         f"tokens: {ties} positions pick another token, largest logit "
         f"gap there {worst_gap:.3e} (allowed < {TIE_GAP:g})")
    _require(worst_gap < TIE_GAP,
             f"the replay disagrees with the engine by a logit gap of "
             f"{worst_gap} >= {TIE_GAP}")


def phase_multitenant() -> dict:
    """GPT-2 345M served by the multi-tenant engine (int8 KV, eight LoRA
    adapters, tenant quota) on bench.py's multi-tenant traffic: the
    schedule submitted at once and held against a plain replay, then
    the same schedule open-loop and timed, then the full-precision
    engine without LoRA on the same traffic, as the bench's oracle."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (LoadSpec, build_requests,
                                          run_open_loop)
    cfg = gpt2_medium()
    L = cfg.num_layers
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    spec = LoadSpec(**MT_SPEC)
    kernels.reset_launch_counts()

    # correctness: the schedule at once, so admission is deterministic
    eng = _mt_engine(model, True)
    states = [eng.submit(r) for _, r in build_requests(spec)]
    eng.run()
    torch.cuda.synchronize()
    stats = eng.stats()
    _log(f"mt: {len(states)} requests of {MT_TENANTS} tenants at once, "
         f"{stats['tokens_generated']} tokens, "
         f"{stats['prefill_dispatches']} prefill and "
         f"{stats['decode_dispatches']} decode dispatches, "
         f"{stats['preemptions']} preemptions, quota deferrals "
         f"{stats['tenant_deferrals']}")
    _mt_replay(model, eng, states)

    # the timed open-loop run, on a fresh engine of the same build
    torch.cuda.reset_peak_memory_stats()
    timed_eng = _mt_engine(model, True)
    summary = run_open_loop(timed_eng, spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}

    n_pre = n_dec = 0
    for e, sts in ((eng, states), (timed_eng, None)):
        st_ = e.stats()
        n_pre += st_["prefill_dispatches"]
        n_dec += st_["decode_dispatches"]
        _require(st_["completed"] == spec.num_requests
                 and st_["failed"] == 0,
                 f"mt: {st_['completed']} of {spec.num_requests} requests "
                 f"completed, {st_['failed']} failed")
        _require(all(n == 0 for n in st_["lora"]["refcounts"].values()),
                 f"mt: adapter references left {st_['lora']['refcounts']}")
        _require(st_["quota_deferred"]
                 == sum(st_["tenant_deferrals"].values()),
                 f"mt: quota_deferred {st_['quota_deferred']} != "
                 f"{st_['tenant_deferrals']}")
    for st, (_, req) in zip(states, build_requests(spec)):
        _require(st.outcome == "completed"
                 and len(st.generated) == req.max_new_tokens,
                 f"mt: request {st.request.request_id} ended {st.outcome} "
                 f"with {len(st.generated)} of {req.max_new_tokens} tokens")
    _log(f"mt: {n_pre} prefill and {n_dec} decode dispatches over both "
         f"runs; launches {launches}")
    _require(launches["bgmv"] == L * (n_pre + n_dec) > 0,
             f"bgmv launches {launches['bgmv']} != {L} x "
             f"({n_pre} + {n_dec}) dispatches")
    _require(launches["paged_decode_attention_quant"] == L * n_dec > 0,
             f"quantized decode launches "
             f"{launches['paged_decode_attention_quant']} != {L} x {n_dec}")
    _require(launches["paged_decode_attention"] == 0,
             f"the int8 engine launched the full-precision decode kernel "
             f"{launches['paged_decode_attention']} times")
    _require(launches["flash_attention_fwd"] >= L * n_pre,
             f"flash launches {launches['flash_attention_fwd']} < {L} x "
             f"{n_pre} prefill dispatches")

    kv_bytes = summary["kv_bytes_per_token"]
    f32_bytes = 2 * L * cfg.num_heads * cfg.head_dim * 4
    _require(kv_bytes == 52224,
             f"int8 KV costs {kv_bytes} bytes a token, not 52224")

    def ms(x):
        return "n/a" if x is None else f"{x * 1e3:.3f} ms"
    _log(f"mt: open loop at {spec.rate_rps:g} requests/s: "
         f"{summary['requests_completed']}/{spec.num_requests} completed, "
         f"{summary['tokens_per_sec']:.2f} tokens/s, TTFT p50 "
         f"{ms(summary['ttft_p50_s'])} p99 {ms(summary['ttft_p99_s'])}, "
         f"decode step p50 {ms(summary['decode_step_p50_s'])} p99 "
         f"{ms(summary['decode_step_p99_s'])}, quota deferrals "
         f"{summary['quota_deferred']}, kv bytes/token {kv_bytes} "
         f"(float32 {f32_bytes}, bfloat16 {f32_bytes // 2}), peak device "
         f"memory {peak:.3f} GiB")

    # the bench's oracle, printed beside it and not gated: random
    # 0.02-init weights decode near-ties, so int8 K/V may flip tokens
    rng = np.random.default_rng(29)
    probe = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
             for n in (9, 6, 12)]
    outs_mt = [o[-8:].tolist() for o in timed_eng.generate(
        probe, max_new_tokens=8)]
    del eng, timed_eng
    gc.collect()
    oracle = _mt_engine(model, False)
    s_off = run_open_loop(oracle, dataclasses.replace(spec, adapter_pool=0))
    outs_off = [o[-8:].tolist() for o in oracle.generate(
        probe, max_new_tokens=8)]
    _log(f"mt: full-precision engine without LoRA on the same traffic: "
         f"{s_off['tokens_per_sec']:.2f} tokens/s, decode step p99 "
         f"{ms(s_off['decode_step_p99_s'])} against "
         f"{ms(summary['decode_step_p99_s'])} multi-tenant (bench budget "
         f"1.5x: {ms(1.5 * s_off['decode_step_p99_s'])}); zero-adapter "
         f"greedy probe equal to it: {outs_mt == outs_off} "
         f"(int8 {outs_mt}, float32 {outs_off})")
    del oracle, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 5 -----------------------------------------------------------------
def _zero_in_exact_arithmetic(name: str) -> bool:
    """The key projection's bias: the softmax ignores the constant q . b
    that it adds to every score of a query row, so its gradient is 0 in
    exact arithmetic and what either side computes is rounding noise
    (about 1e-9 against 6e-3 for the weight, 2-layer BERT-base on the
    CPU). Its error relative to its own largest entry means nothing; it
    is held to PARITY_GRAD_TOL of the largest entry of any gradient."""
    return name.endswith("self_attn.k_proj.bias")


def _grads_close(tag, results):
    """The card's and the CPU's (loss, gradients) of one step: the loss's
    relative error, the worst gradient's max abs error over its own max
    |cpu|, that gradient's name and the number of gradients. Gradients
    that are 0 in exact arithmetic are left out of the worst, logged,
    and each must stay within ``PARITY_GRAD_TOL`` of the largest |cpu|
    entry of any gradient on both sides."""
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    _require(set(g_gpu) == set(g_cpu), f"{tag}: gradients of other "
             f"parameters on the card and the CPU")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    largest = max(g.abs().max().item() for g in g_cpu.values())
    errs = {}
    for n in g_cpu:
        if _zero_in_exact_arithmetic(n):
            got, ref = (g[n].abs().max().item() for g in (g_gpu, g_cpu))
            _log(f"{tag}: {n} is 0 in exact arithmetic: max |card| "
                 f"{got:.3e}, max |cpu| {ref:.3e} (tol {PARITY_GRAD_TOL:g}"
                 f" of the largest gradient entry, {largest:.3e})")
            _require(max(got, ref) <= PARITY_GRAD_TOL * largest,
                     f"{tag}: gradient {n} should be 0, reads {got} on the "
                     f"card and {ref} on the CPU")
            continue
        errs[n] = ((g_gpu[n] - g_cpu[n]).abs().max()
                   / g_cpu[n].abs().max().clamp(min=1e-30)).item()
    worst_name = max(errs, key=errs.get)
    return loss_err, errs[worst_name], worst_name, len(g_cpu)


def phase_parity() -> None:
    """One float32 forward and backward of a 2-layer, full-width GPT with
    dropout on the card and on the CPU, from the same weights, batch and
    seed words: the CPU runs the kernels' plain versions."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium)
    from paddle_tpu_torch.ops import kernels
    cfg = gpt2_medium(num_layers=PARITY_LAYERS)
    rng = np.random.default_rng(1)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PARITY_B, PARITY_S)).astype(np.int32))
        for _ in range(2))
    crit = GPTPretrainingCriterion()
    results = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = GPTForPretraining(cfg, device="cpu", seed=0).to(dev)
        before = {k["name"]: k["launches"] for k in kernels.kernels()}
        loss = crit(model(ids.to(dev), generator=torch.Generator()
                          .manual_seed(5)), labels.to(dev))
        loss.backward()
        launched = sum(k["launches"] - before[k["name"]]
                       for k in kernels.kernels())
        results[dev] = (loss.item(), {n: p.grad.detach().cpu()
                                      for n, p in model.named_parameters()})
        _log(f"parity: {dev} loss {results[dev][0]:.6f} in "
             f"{time.perf_counter() - t0:.2f} s, {launched} kernel "
             f"launches")
        _require((launched > 0) == (dev == "cuda"),
                 f"{dev} run launched {launched} kernels")
        del model, loss
    loss_err, worst, worst_name, n = _grads_close("parity", results)
    _log(f"parity: gpt2_medium(num_layers={PARITY_LAYERS}) f32 B={PARITY_B} "
         f"S={PARITY_S} dropout {cfg.hidden_dropout_prob}: |loss| rel err "
         f"{loss_err:.3e} (tol {PARITY_LOSS_TOL:g}), worst gradient "
         f"{worst_name} {worst:.3e} (max abs err / max |cpu|, tol "
         f"{PARITY_GRAD_TOL:g}) over {n} gradients")
    _require(loss_err <= PARITY_LOSS_TOL,
             f"card and CPU losses differ: {results['cuda'][0]} vs "
             f"{results['cpu'][0]}")
    _require(worst <= PARITY_GRAD_TOL,
             f"gradient {worst_name} differs between card and CPU ({worst})")


# -- phase 6 -----------------------------------------------------------------
@contextlib.contextmanager
def _plain_versions(names=None, mxu: bool = True):
    """Inside the block every kernel wrapper that the training, serving
    and inference paths call computes its plain version, on CUDA tensors
    too: the reference of phases 4, 6, 9, 11, 12 and 13; with ``names``
    only the wrappers of those names. Given bf16 inputs, the flash
    attention plain versions round their products' operands to bf16
    (``mxu_dtype``), as the TPU kernels' ``_dot`` and the tensor-core
    kernels do; ``mxu=False`` keeps them in float32. Only this script
    swaps them; the port has no such switch. ``models.gpt`` binds the
    serving wrappers by name, so they are swapped there as well."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels import bgmv as bg
    from paddle_tpu_torch.ops.kernels import chunked_ce as ce
    from paddle_tpu_torch.ops.kernels import dropout as dr
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import paged_decode as pd
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    def op(q):
        return torch.bfloat16 if mxu and q.dtype == torch.bfloat16 else None

    # slim and nn.functional reach int8_matmul through quant_matmul's own
    # int8_linear and int8_amp_linear, so one swap covers both
    swaps = ((pd, "paged_decode_attention", pd.paged_decode_plain),
             (qm, "int8_matmul", qm.int8_matmul_plain),
             (gpt, "paged_decode_attention", pd.paged_decode_plain),
             (pd, "paged_decode_attention_quant",
              pd.paged_decode_quant_plain),
             (gpt, "paged_decode_attention_quant",
              pd.paged_decode_quant_plain),
             (bg, "bgmv", bg.bgmv_plain),
             (gpt, "bgmv", bg.bgmv_plain),
             (fa, "flash_attention_fwd",
              lambda q, k, v, *a: fa.flash_attention_plain(
                  q, k, v, *a, mxu_dtype=op(q))),
             (fa, "flash_attention_bwd",
              lambda q, k, v, o, lse, do, *a: fa.flash_attention_bwd_plain(
                  q, k, v, o, lse, do, *a, mxu_dtype=op(q))),
             (ce, "online_lse", ce.online_lse_plain),
             (ce, "dlogits", ce.dlogits_plain),
             (dr, "dropout_apply", dr.dropout_plain),
             (fa, "flash_attention_bias_fwd",
              lambda q, k, v, bias, *a: fa.flash_attention_plain(
                  q, k, v, *a, bias=bias, mxu_dtype=op(q))),
             (fa, "flash_attention_bias_bwd_dq",
              lambda q, k, v, bias, o, lse, do, *a:
              fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *a,
                                           bias=bias, mxu_dtype=op(q))[0]),
             (fa, "flash_attention_bias_bwd_dkv",
              lambda q, k, v, bias, o, lse, do, *a:
              fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *a,
                                           bias=bias, mxu_dtype=op(q))[1:]))
    if names is not None:
        swaps = tuple(sw for sw in swaps if sw[1] in names)
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _train_setup(amp: bool):
    """gpt2_medium, its TrainStep (AdamW, dropout generator seed 0) and the
    batch, as phase 7 and ``bench_gpt2_345m`` build them."""
    import numpy as np
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_medium()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        if not amp:
            return crit(layer(ids), labels)
        with auto_cast(level="O1"):
            return crit(layer(ids), labels)

    step = TrainStep(model, loss_fn, AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters(),
        weight_decay=TRAIN_WD), seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size,
                          (TRAIN_B, TRAIN_S)).astype(np.int32)
    return cfg, model, loss_fn, step, ids, labels


# the whole-step witnesses' second every-plain reference, printed only:
# its flash plain versions keep the products' operands in float32, so it
# differs from the kernels by their bf16 roundings of q, k, v, pv and ds
F32_PLAIN = ("plain f32", None, math.inf, math.inf, False)


def _witness(tag: str, step, loss_fn, batch, n: int,
             loss_tol: float = AMP_LOSS_TOL, refs=None,
             readings=None) -> list:
    """``n`` steps of ``step`` on ``batch`` (numpy arrays), each held
    against references on the card: before every step the same loss
    and gradients are computed from the same parameters and seed words
    with kernel wrappers swapped for their plain versions, and the
    step's loss and gradients must agree with each reference. ``refs``
    holds ``(label, names, loss_tol, grad_tol)``, optionally followed by
    ``_plain_versions``' ``mxu``: ``names`` None swaps every wrapper (the
    default reference, held to ``loss_tol`` and ``AMP_GRAD_TOL``, and
    ``F32_PLAIN`` printed beside it; it must launch no kernel), else only
    those, and
    the kernels such a reference launches are taken back out of the
    launch counts, so that the counts read after the steps are the
    steps' own. A parameter the loss does not reach has a zero gradient
    on both sides, as ``TrainStep`` gives it. Each step's ``(label,
    step, loss error, gradient error)`` is appended to ``readings`` when
    it is given. Returns the losses."""
    import torch
    from paddle_tpu_torch.core.random import dropout_generator
    from paddle_tpu_torch.ops import kernels
    if refs is None:
        refs = (("plain", None, loss_tol, AMP_GRAD_TOL), F32_PLAIN)
    model, opt = step.layer, step.optimizer
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    n_zero = sum(_zero_in_exact_arithmetic(k) for k, _ in named)
    skipped = (f" ({n_zero} gradients 0 in exact arithmetic left out)"
               if n_zero else "")
    kernel_grads = {}
    update = opt.step

    def keep_grads_then_update(step=None):
        kernel_grads.update((k, p.grad.detach().clone()) for k, p in named)
        update(step=step)

    opt.step = keep_grads_then_update
    batch_t = [torch.from_numpy(a).cuda() for a in batch]
    losses, plain_losses = [], {label: [] for label, *_ in refs}
    try:
        for t in range(1, n + 1):
            results = []
            for label, names, l_tol, g_tol, *mxu in refs:
                gen = torch.Generator()
                gen.set_state(step.generator.get_state())
                counts = {k: v.launches for k, v in kernels.KERNELS.items()}
                with _plain_versions(names, *mxu):
                    with dropout_generator(gen):
                        ref = loss_fn(model, *batch_t)
                    ref.backward()
                _require(names is not None or all(
                    v.launches == counts[k]
                    for k, v in kernels.KERNELS.items()),
                    "the plain reference launched a kernel")
                for k, v in kernels.KERNELS.items():
                    v.launches = counts[k]
                results.append((label, l_tol, g_tol, ref.item(), {
                    k: torch.zeros_like(p) if p.grad is None else p.grad
                    for k, p in named}))
                opt.clear_grad()
                del ref
            losses.append(float(step(*batch)))
            for label, l_tol, g_tol, ref_loss, plain_grads in results:
                plain_losses[label].append(ref_loss)
                num = den = 0.0
                worst, worst_name = 0.0, ""
                for k, ref_g in plain_grads.items():
                    d = kernel_grads[k] - ref_g
                    num += float(d.square().sum())
                    den += float(ref_g.square().sum())
                    if _zero_in_exact_arithmetic(k):
                        continue
                    r = float(d.abs().max()
                              / ref_g.abs().max().clamp(min=1e-30))
                    if r > worst:
                        worst, worst_name = r, k
                loss_err = abs(losses[-1] - ref_loss) / abs(ref_loss)
                g_err = math.sqrt(num / den)
                if readings is not None:
                    readings.append((label, t, loss_err, g_err))
                _log(f"{tag}: step {t} loss {losses[-1]:.5f}, {label} "
                     f"{ref_loss:.5f} (rel err {loss_err:.3e}, tol "
                     f"{l_tol:g}); gradients |kernel-{label}|/|{label}| "
                     f"{g_err:.3e} (tol {g_tol:g}), worst tensor "
                     f"{worst_name} max abs err / max |{label}| "
                     f"{worst:.3e}{skipped}")
                _require(math.isfinite(losses[-1]) and loss_err <= l_tol,
                         f"{tag} step {t}: O1 loss {losses[-1]} vs {label} "
                         f"{ref_loss}")
                _require(g_err <= g_tol,
                         f"{tag} step {t}: O1 gradients differ from the "
                         f"{label} ones by {g_err} of their norm")
            del results
            kernel_grads.clear()
    finally:
        del opt.step   # the wrapper held the optimizer in a cycle
    _log(f"{tag}: O1 losses with the kernels " + " ".join(
        f"{x:.5f}" for x in losses))
    for label, xs in plain_losses.items():
        _log(f"{tag}: O1 losses, {label} " + " ".join(f"{x:.5f}" for x in xs))
    return losses


def phase_amp() -> list:
    """The O1 training steps, each held against the plain versions from
    the same parameters and seed words; returns the losses."""
    import torch
    _, _, loss_fn, step, ids, labels = _train_setup(amp=True)
    losses = _witness("amp", step, loss_fn, (ids, labels), TRAIN_STEPS)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    step32, ids, labels = _train_setup(amp=False)[3:]
    f32 = [float(step32(ids, labels)) for _ in range(TRAIN_STEPS)]
    _log("amp: float32 losses, same weights " + " ".join(
        f"{x:.5f}" for x in f32))
    del step32
    gc.collect()
    torch.cuda.empty_cache()
    return losses


# -- phase 7 -----------------------------------------------------------------
def gpt_flops_per_token(h=1024, L=24, V=50304, S=1024) -> float:
    """Analytic training FLOPs per token (6P + attention term), as
    ``bench.py::gpt_flops_per_token``."""
    p_block = L * 12 * h * h
    return 6 * (p_block + V * h) + 12 * L * h * S


# kernel-name fragments of each group in the step profile; the first
# group whose fragment a kernel's name holds takes it
PROFILE_GROUPS = (
    ("flash forward", ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
    ("flash backward", ("dkv_kernel", "dq_kernel", "dkv_tc_kernel",
                        "dq_tc_kernel", "delta_kernel", "db_sum_kernel")),
    ("chunked CE", ("lse_kernel", "dlogits_kernel")),
    ("int8 matmul", ("int8_matmul_kernel",)),
    ("dropout", ("dropout_kernel",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("copies and casts", ("copy_kernel", "CatArrayBatched")),
    ("elementwise", ("elementwise_kernel",)),
    ("reductions", ("reduce_kernel",)),
)


def _profile_step(tag: str, fn) -> None:
    """Device time by kernel over one more call of ``fn`` (a step or a
    predictor run; torch.profiler), as ``tools/profile_torch_serve.py``
    reads it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                 key=lambda a: -a.self_device_time_total)
    busy = sum(a.self_device_time_total for a in dev) / 1e3     # us -> ms
    n_launch = sum(a.count for a in avgs
                   if a.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    _log(f"{tag}: profiled step {wall * 1e3:.1f} ms wall, kernels busy "
         f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), {n_launch} "
         f"kernel launches")
    groups = {}
    for a in dev:
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in a.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + a.self_device_time_total
    _log(f"{tag}: device time by group: " + ", ".join(
        f"{g} {us / 1e3:.1f} ms ({100 * us / 1e3 / max(busy, 1e-9):.1f}%)"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])))
    for a in dev[:15]:
        ms = a.self_device_time_total / 1e3
        _log(f"{tag}:   {ms:9.3f} ms {100 * ms / max(busy, 1e-9):5.1f}% "
             f"x{a.count:<5d} {a.key[:90]}")


def phase_train(amp_losses: list) -> dict:
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    cfg, _, _, step, ids, labels = _train_setup(amp=True)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))       # syncs on the loss
        times.append(time.perf_counter() - t0)
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    _log("train: losses " + " ".join(f"{x:.4f}" for x in losses))
    _log(f"train: largest difference from phase 6's losses (same seeds) "
         f"{max(abs(a - b) for a, b in zip(losses, amp_losses)):.3e}")
    _log(f"train: launches over {TRAIN_STEPS} steps {launches}")
    _require(all(math.isfinite(x) for x in losses), "non-finite loss")
    _require(losses[-1] < losses[0],
             f"loss did not decrease: {losses[0]} -> {losses[-1]}")
    L, n = cfg.num_layers, TRAIN_STEPS
    drops = 1 + 2 * L                                  # per forward
    want = {"flash_attention_fwd": L * n, "flash_attention_bwd": L * n,
            "chunked_ce_lse": n, "chunked_ce_dlogits": n,
            "fused_dropout": 2 * drops * n, "paged_decode_attention": 0,
            "flash_attention_bias_fwd": 0, "flash_attention_bias_bwd_dq": 0,
            "flash_attention_bias_bwd_dkv": 0,
            "paged_decode_attention_quant": 0, "bgmv": 0, "int8_matmul": 0}
    _require(launches == want, f"launch counts {launches} != {want}")

    step_s = float(np.median(times[2:]))
    tokens = TRAIN_B * TRAIN_S
    mfu = gpt_flops_per_token(S=TRAIN_S) * tokens / step_s / \
        PEAK_FLOPS["bfloat16"]
    _log(f"train: gpt2_medium B={TRAIN_B} S={TRAIN_S} AMP O1 dropout "
         f"{cfg.hidden_dropout_prob} AdamW: step 1 {times[0] * 1e3:.1f} ms,"
         f" median over steps 3-{TRAIN_STEPS} {step_s * 1e3:.2f} ms/step, "
         f"{tokens / step_s:.1f} tokens/s, MFU {mfu:.4f} (against 989 "
         f"TFLOP/s bf16 dense), peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _profile_step("train", lambda: float(step(ids, labels)))
    return launches


# -- phases 8-11: BERT and ERNIE ---------------------------------------------
def phase_bert_parity() -> None:
    """One float32 forward and backward of a 2-layer, full-width BERT-base
    MLM with dropout and a padded row, on the card and on the CPU from
    the same weights, batch and seed words: the CPU runs every kernel's
    plain version, so the loss and every gradient hold the biased flash
    kernels (and the chunked CE and dropout) to them at full width."""
    import torch
    from paddle_tpu_torch.models import BertForMaskedLM, bert_base
    from paddle_tpu_torch.ops import kernels
    cfg = bert_base(num_layers=BERT_PARITY_LAYERS)
    batch, _ = pretraining_batch(BERT_PARITY_B, BERT_S, BERT_M,
                                 cfg.vocab_size, seed=1,
                                 lengths=(BERT_S, BERT_PARITY_LEN))
    results = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = BertForMaskedLM(cfg, device="cpu", seed=0).to(dev)
        ids, tt, mask, pos, labels, w = (torch.from_numpy(a).to(dev)
                                         for a in batch)
        before = sum(k["launches"] for k in kernels.kernels())
        loss = model.loss(model(ids, tt, mask, pos,
                                generator=torch.Generator().manual_seed(5)),
                          labels, w)
        loss.backward()
        launched = sum(k["launches"] for k in kernels.kernels()) - before
        results[dev] = (loss.item(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None})
        _log(f"bert parity: {dev} loss {results[dev][0]:.6f} in "
             f"{time.perf_counter() - t0:.2f} s, {launched} kernel launches")
        _require((launched > 0) == (dev == "cuda"),
                 f"{dev} run launched {launched} kernels")
        del model, loss
    loss_err, worst, worst_name, n = _grads_close("bert parity", results)
    _log(f"bert parity: bert_base(num_layers={BERT_PARITY_LAYERS}) f32 "
         f"B={BERT_PARITY_B} S={BERT_S} (row 1 padded to "
         f"{BERT_PARITY_LEN}) dropout {cfg.hidden_dropout_prob}: |loss| rel "
         f"err {loss_err:.3e} (tol {PARITY_LOSS_TOL:g}), worst gradient "
         f"{worst_name} {worst:.3e} (max abs err / max |cpu|, tol "
         f"{PARITY_GRAD_TOL:g}) over {n} gradients")
    _require(loss_err <= PARITY_LOSS_TOL, "card and CPU BERT losses differ")
    _require(worst <= PARITY_GRAD_TOL,
             f"gradient {worst_name} differs between card and CPU ({worst})")


def _encoder_setup(kind: str):
    """BERT-base MLM or ERNIE-base pretraining at the bench configuration:
    the model (seed 0), its O1 loss, its TrainStep (AdamW, dropout
    generator seed 0) and the padded batch as numpy arrays."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertForMaskedLM,
                                         ErnieForPretraining, bert_base,
                                         ernie_base)
    from paddle_tpu_torch.optimizer import AdamW
    if kind == "bert":
        cfg = bert_base()
        model = BertForMaskedLM(cfg, device="cuda", seed=0)

        def loss_fn(layer, ids, tt, mask, pos, labels, w):
            with auto_cast(level="O1"):
                return layer.loss(layer(ids, tt, mask, pos), labels, w)
    else:
        cfg = ernie_base()
        model = ErnieForPretraining(cfg, device="cuda", seed=0)

        def loss_fn(layer, ids, tt, mask, pos, labels, w, sop):
            with auto_cast(level="O1"):
                return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)

    step = TrainStep(model, loss_fn, AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters(),
        weight_decay=TRAIN_WD), seed=0)
    batch, sop = pretraining_batch(BERT_B, BERT_S, BERT_M, cfg.vocab_size)
    _require((batch[2] == 0).any(), "the batch has no padded row")
    if kind == "ernie":
        batch = batch + (sop,)
    return cfg, loss_fn, step, batch


def _encoder_launches(cfg, n: int) -> dict:
    """Exact launches of ``n`` BERT or ERNIE O1 steps."""
    L = cfg.num_layers
    return {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "chunked_ce_lse": n, "chunked_ce_dlogits": n,
            "fused_dropout": 2 * (1 + 2 * L) * n,
            "paged_decode_attention": 0,
            "flash_attention_bias_fwd": L * n,
            "flash_attention_bias_bwd_dq": L * n,
            "flash_attention_bias_bwd_dkv": L * n,
            "paged_decode_attention_quant": 0, "bgmv": 0, "int8_matmul": 0}


def phase_bert_witness() -> list:
    """BERT's first O1 steps, each held against the plain versions from
    the same parameters and seed words."""
    import torch
    _, loss_fn, step, batch = _encoder_setup("bert")
    losses = _witness("bert witness", step, loss_fn, batch,
                      BERT_WITNESS_STEPS)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def bert_flops_per_token(cfg, S=BERT_S, M=BERT_M) -> float:
    """Analytic training FLOPs per token, as ``bench.py``'s
    ``bench_bert_mlm`` counts them (the head GEMM at the masked
    positions only)."""
    h, L = cfg.hidden_size, cfg.num_layers
    return 6 * (12 * L * h * h + cfg.vocab_size * h * M / S) + \
        12 * L * h * S


def phase_bert_train(witness: list) -> dict:
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    cfg, _, step, batch = _encoder_setup("bert")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))            # syncs on the loss
        times.append(time.perf_counter() - t0)
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    _log("bert: losses " + " ".join(f"{x:.4f}" for x in losses))
    _log(f"bert: largest difference from the witness steps' losses (same "
         f"seeds) {max(abs(a - b) for a, b in zip(losses, witness)):.3e}")
    _log(f"bert: launches over {BERT_STEPS} steps {launches}")
    _require(all(math.isfinite(x) for x in losses), "non-finite BERT loss")
    want = _encoder_launches(cfg, BERT_STEPS)
    _require(launches == want, f"launch counts {launches} != {want}")
    step_s = float(np.median(times[2:]))
    tokens = BERT_B * BERT_S
    mfu = bert_flops_per_token(cfg) * tokens / step_s / \
        PEAK_FLOPS["bfloat16"]
    _log(f"bert: bert_base MLM B={BERT_B} S={BERT_S} M={BERT_M} "
         f"({int((batch[2] == 0).any(1).sum())} padded rows) AMP O1 dropout "
         f"{cfg.hidden_dropout_prob} AdamW: step 1 {times[0] * 1e3:.1f} ms, "
         f"median over steps 3-{BERT_STEPS} {step_s * 1e3:.2f} ms/step, "
         f"{tokens / step_s:.1f} tokens/s, MFU {mfu:.4f} (against 989 "
         f"TFLOP/s bf16 dense), peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _profile_step("bert", lambda: float(step(*batch)))
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_ernie() -> dict:
    import torch
    from paddle_tpu_torch.ops import kernels
    cfg, loss_fn, step, batch = _encoder_setup("ernie")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    # each step held against the plain versions, which launch nothing
    losses = _witness("ernie", step, loss_fn, batch, ERNIE_STEPS,
                      ERNIE_LOSS_TOL)
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    _log(f"ernie: ernie_base B={BERT_B} S={BERT_S} M={BERT_M} AMP O1, no "
         f"task-type ids: losses " + " ".join(f"{x:.4f}" for x in losses)
         + f"; launches over {ERNIE_STEPS} steps {launches}")
    _require(all(math.isfinite(x) for x in losses), "non-finite ERNIE loss")
    want = _encoder_launches(cfg, ERNIE_STEPS)
    _require(launches == want, f"launch counts {launches} != {want}")
    times = []
    for _ in range(ERNIE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))            # syncs on the loss
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[len(times) // 2]
    _log(f"ernie: steps {ERNIE_STEPS + 1}-{2 * ERNIE_STEPS} losses "
         + " ".join(f"{x:.4f}" for x in losses[ERNIE_STEPS:])
         + f", median {step_s * 1e3:.2f} ms/step, "
         f"{BERT_B * BERT_S / step_s:.1f} tokens/s")
    _require(all(math.isfinite(x) for x in losses), "non-finite ERNIE loss")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phases 12-13: int8 inference and the AMP int8 linear -------------------
# predictor runs timed after the warm-up runs. The f32 predictor is
# replayed with every plain version and held to PREDICT_F32_PLAIN_TOL of
# the largest score: the flash kernel against plain attention on the
# model's own path. Each quantized predictor is replayed with
# int8_matmul's plain version alone, which must give the same scores bit
# for bit (every one of the 74 products sees the activations the kernel
# saw), and with every plain version, printed only: there the flash
# kernel's last bits may round an activation of the next layer to the
# other int8 neighbour, and the layers after it carry that quantum
PREDICT_WARMUP, PREDICT_RUNS = 2, 10
PREDICT_F32_PLAIN_TOL = 1e-4
# the O1 steps under FLAGS_amp_int8_matmul, held against two references:
# int8_matmul's plain version alone (every other kernel the same, so the
# step must repeat it to float32 noise), and every plain version (phase
# 6's witness), where the MLP inputs' quantization flips as in the
# predictor replay. tools/amp_int8_witness_spread.py measured on one
# H100, with the bf16 forward and backward on the tensor cores, the
# gradients of 4 batches x 3 sound steps at most 4.255e-02 of their norm
# off (every first step 4.09e-02 to 4.26e-02; 3.52e-02 to 3.65e-02 when
# the forward ran on the CUDA cores in f32), and one step with a fault
# planted in a kernel at 5.731e-02 (the flash backward without its
# dropout) to 8.797e-01 (the fused dropout on another mask)
AMP_INT8_STEPS = 3
AMP_INT8_EXACT_TOL = 1e-6
AMP_INT8_GRAD_TOL = 4.5e-2


def _predictor(kind: str, calib=()):
    """A ``create_predictor`` over a fresh BERT-base MLM (seed 0) on the
    card: ``f32``, ``int8`` (``enable_int8``), ``int8+bf16`` (also
    ``enable_tpu_bf16``) or ``ptq`` (static activation scales from the
    ``calib`` batches, in eval mode). Returns it and its layer."""
    import torch
    from paddle_tpu_torch import inference, slim
    from paddle_tpu_torch.models import BertForMaskedLM, bert_base
    model = BertForMaskedLM(bert_base(), device="cuda", seed=0)
    if kind == "ptq":
        model.eval()
        ptq = slim.PostTrainingQuantization(model)
        for b in calib:
            ptq.collect(*(torch.from_numpy(a).cuda() for a in b))
        model = ptq.run()
    cfg = inference.Config.from_layer(
        model, [(BERT_B, BERT_S)] * 3 + [(BERT_B, BERT_M)])
    if kind != "f32" and kind != "ptq":
        cfg.enable_int8()
    if kind == "int8+bf16":
        cfg.enable_tpu_bf16()
    return inference.create_predictor(cfg), model


def phase_predict() -> dict:
    """BERT-base MLM inference through ``inference.create_predictor`` on
    the BERT path's padded batch: f32, int8, int8 + bf16 and static PTQ
    predictors, each with exact launch counts; the f32 one held against
    its replay with every plain version, the quantized ones against their
    replay with int8_matmul's plain version (bit-equal); the first three
    timed; quality against f32 printed."""
    import numpy as np
    import torch
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import quant_matmul
    batch, _ = pretraining_batch(BERT_B, BERT_S, BERT_M, 30528)
    inputs, real = list(batch[:4]), batch[5] > 0
    calib = [pretraining_batch(BERT_B, BERT_S, BERT_M, 30528, seed=s)[0][:4]
             for s in (1, 2)]
    n_lin, L = 74, 12
    total = {k.name: 0 for k in kernels.KERNELS.values()}
    scores = {}
    for kind in ("f32", "int8", "int8+bf16", "ptq"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred, layer = _predictor(kind, calib if kind == "ptq" else ())
        n_q = sum(isinstance(m, slim.QuantizedLinear) for m in layer.modules())
        _require(n_q == (0 if kind == "f32" else n_lin),
                 f"predict {kind}: {n_q} QuantizedLinear layers")
        kernels.reset_launch_counts()
        copies = quant_matmul.layout_copies
        out = pred.run(inputs)[0]
        runs = 1
        _require(out.shape == (BERT_B, BERT_M, 30528)
                 and out.dtype == np.float32 and np.isfinite(out).all(),
                 f"predict {kind}: scores {out.shape} {out.dtype}, finite "
                 f"{np.isfinite(out).all()}")
        times = []
        if kind != "ptq":
            for i in range(PREDICT_WARMUP + PREDICT_RUNS):
                t0 = time.perf_counter()
                pred.run(inputs)                  # numpy out: synced
                if i >= PREDICT_WARMUP:
                    times.append(time.perf_counter() - t0)
            runs += PREDICT_WARMUP + PREDICT_RUNS
        if kind in ("f32", "int8"):
            _profile_step(f"predict {kind}", lambda: pred.run(inputs))
            runs += 1
        launches = {k["name"]: k["launches"] for k in kernels.kernels()}
        want = {k: 0 for k in launches}
        want["flash_attention_bias_fwd"] = L * runs
        want["int8_matmul"] = 0 if kind == "f32" else n_lin * runs
        _require(launches == want and not kernels.FALLBACKS,
                 f"predict {kind}: launches {launches} != {want}, shape "
                 f"fallbacks {kernels.FALLBACKS}")
        for k, n in launches.items():
            total[k] += n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        copies = quant_matmul.layout_copies - copies
        _require(copies == 0, f"predict {kind}: {copies} K-major copies of "
                              f"a weight (QuantizedLinear holds it K-major)")
        msg = (f"predict {kind}: {runs} runs, launches int8_matmul "
               f"{launches['int8_matmul']}, flash_attention_bias_fwd "
               f"{launches['flash_attention_bias_fwd']}, every other kernel "
               f"0, shape fallbacks 0, weight layout copies 0; peak device "
               f"memory {peak:.3f} GiB")
        if times:
            med = float(np.median(times))
            msg += (f"; median {med * 1e3:.2f} ms a run over "
                    f"{PREDICT_RUNS} after {PREDICT_WARMUP} warm-up "
                    f"(min {min(times) * 1e3:.2f}, max "
                    f"{max(times) * 1e3:.2f}), "
                    f"{BERT_B * BERT_S / med:.1f} tokens/s")
        _log(msg)
        if kind != "f32":
            with _plain_versions({"int8_matmul"}):
                ref = pred.run(inputs)[0]
            _require(kernels.INT8_MATMUL.launches == want["int8_matmul"],
                     "the int8 replay launched the int8 kernel")
            _log(f"predict {kind}: replay with int8_matmul's plain version "
                 f"bit-equal: {np.array_equal(out, ref)}")
            _require(np.array_equal(out, ref),
                     f"predict {kind} differs from its int8 plain replay by "
                     f"{np.abs(out - ref).max()}")
        before = sum(k["launches"] for k in kernels.kernels())
        with _plain_versions():
            ref = pred.run(inputs)[0]
        _require(sum(k["launches"] for k in kernels.kernels()) == before,
                 "the plain replay launched a kernel")
        d = np.abs(out - ref)
        big = np.abs(ref).max()
        rel = float(d.max() / big)
        agree = float((out.argmax(-1) == ref.argmax(-1))[real].mean())
        gate = (f"tol {PREDICT_F32_PLAIN_TOL:g}" if kind == "f32"
                else "not gated")
        _log(f"predict {kind}: against the replay with every plain "
             f"version: max |score-plain| / max|plain| {rel:.3e} ({gate}), "
             f"mean {d.mean() / big:.3e}, 99.9th percentile "
             f"{np.percentile(d, 99.9) / big:.3e}, argmax agrees at "
             f"{agree:.4f} of the masked positions")
        _require(kind != "f32" or rel <= PREDICT_F32_PLAIN_TOL,
                 f"predict f32 differs from its plain replay by {rel}")
        del ref, d
        scores[kind] = out
        del pred, layer
        gc.collect()
        torch.cuda.empty_cache()
    a = scores["f32"]
    top = a.argmax(-1)
    for kind in ("int8", "int8+bf16", "ptq"):
        rel = float(np.abs(scores[kind] - a).max() / np.abs(a).max())
        agree = float((scores[kind].argmax(-1) == top)[real].mean())
        _log(f"predict {kind} against f32 (not gated): max |diff| / max|f32| "
             f"{rel:.3e}, argmax agrees at {agree:.4f} of the "
             f"{int(real.sum())} masked positions")
    return total


def phase_amp_int8() -> dict:
    """Phase 7's O1 GPT-2 345M steps under ``FLAGS_amp_int8_matmul``:
    each MLP linear runs through the int8 kernel, each step held against
    int8_matmul's plain version and against every plain version (phase
    6's witness), exact launch counts."""
    import torch
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import quant_matmul
    cfg, _, loss_fn, step, ids, labels = _train_setup(amp=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    copies = quant_matmul.layout_copies
    refs = (("int8 plain", {"int8_matmul"}, AMP_INT8_EXACT_TOL,
             AMP_INT8_EXACT_TOL),
            ("plain", None, AMP_LOSS_TOL, AMP_INT8_GRAD_TOL), F32_PLAIN)
    with flag_scope("amp_int8_matmul", True):
        losses = _witness("amp_int8", step, loss_fn, (ids, labels),
                          AMP_INT8_STEPS, refs=refs)
    # the steps' own launches: _witness takes the int8-plain
    # references' launches back out of the counts
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    L, n = cfg.num_layers, AMP_INT8_STEPS
    want = {"flash_attention_fwd": L * n, "flash_attention_bwd": L * n,
            "chunked_ce_lse": n, "chunked_ce_dlogits": n,
            "fused_dropout": 2 * (1 + 2 * L) * n,
            "paged_decode_attention": 0, "flash_attention_bias_fwd": 0,
            "flash_attention_bias_bwd_dq": 0,
            "flash_attention_bias_bwd_dkv": 0,
            "paged_decode_attention_quant": 0, "bgmv": 0,
            "int8_matmul": 2 * L * n}
    _log(f"amp_int8: launches over {n} steps {launches}; K-major copies "
         f"of a quantized weight {quant_matmul.layout_copies - copies} "
         f"(one per forward launch of the kernel, outside it)")
    _require(all(math.isfinite(x) for x in losses), "non-finite loss")
    _require(launches == want and not kernels.FALLBACKS,
             f"launch counts {launches} != {want}, shape fallbacks "
             f"{kernels.FALLBACKS}")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- main --------------------------------------------------------------------
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

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        _log(f"{name}: phase took {time.perf_counter() - t:.1f} s")
        return out

    timed("card", phase_card)
    rows = timed("kernels", phase_kernels)
    by_path = {"serve": timed("slice", phase_slice)}
    by_path["mt"] = timed("mt", phase_multitenant)
    timed("parity", phase_parity)
    amp_losses = timed("amp", phase_amp)
    by_path["train"] = timed("train", phase_train, amp_losses)
    timed("bert parity", phase_bert_parity)
    witness = timed("bert witness", phase_bert_witness)
    by_path["bert"] = timed("bert", phase_bert_train, witness)
    by_path["ernie"] = timed("ernie", phase_ernie)
    by_path["predict"] = timed("predict", phase_predict)
    by_path["amp_int8"] = timed("amp_int8", phase_amp_int8)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "paddle_tpu" or m.startswith("paddle_tpu."))
    _require(not leaked, f"the port imported {leaked[:5]}")

    from paddle_tpu_torch.ops import kernels
    line = []
    for k in kernels.kernels():
        r = rows[k["name"]]
        paths = {p: n[k["name"]] for p, n in by_path.items()}
        line.append({"name": k["name"], "route": "cuda",
                     "source": k["source"], "replaces": k["replaces"],
                     "launches": sum(paths.values()),
                     "launches_by_path": paths,
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
