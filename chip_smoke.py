#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``paddle_tpu``, and it has no
fallback: any failure raises and the script exits non-zero without its
result line. Twenty-two phases, in order:

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
              must give the same bits; the biased forward also causal at
              Sq < Sk as the chat path's context prefills launch it (Sq =
              128 and 5 over a 512-token right-aligned context, f32 and
              bf16, a row that sees one key and a fully masked row),
              timed at the chat context shape against SDPA f32 given the
              same float mask;
3. slice   -- serve 16 greedy requests on GPT-2 345M (random weights
              from a seed) through ``ServingEngine`` at the full serving
              configuration, check the launch counts against the
              dispatch counts and cross-check every generated token
              against a teacher-forced no-cache forward, then profile one
              more run of the same requests (the device busy share
              phase 14 prints beside its own);
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
14. bf16   -- phase 3's requests through ``inference.create_serving_engine``
              under ``enable_tpu_bf16`` with bf16 pools
              (``cache_dtype="bfloat16"``): layer norm's one-launch bf16
              path bit-equal to its f32 casts, exact launch counts (the
              flash and paged-decode kernels in bf16), every token against
              a teacher-forced no-cache forward of the engine's bf16
              parameters (near-ties under ``BF16_TIE_GAP``), KV bytes a
              token half of f32's; its TTFT, decode p50/p99, peak memory
              and the device busy share of one profiled run printed beside
              phase 3's (which profiles one more f32 run for it);
15. chat   -- ``bench.py``'s ``serve_throughput_features`` at full size:
              its MMPP shared-prefix chat traffic (24 requests after a warm
              burst of 4) served open-loop by the flags-off engine and by
              one with the radix prefix cache, chunked prefill at 128 and
              speculative decoding at k = 4; bench.py's three parity
              prompts token-identical (near-ties at the first divergence
              under ``TIE_GAP``), every request completed and every token
              checked against a teacher-forced forward, exact launch counts
              (the biased flash kernel, causal, once per layer per context
              prefill and verify dispatch; the plain flash kernel per fresh
              prefill; paged decode per plain decode), every page's
              refcount the tree's at the end; tokens/s and TTFT p99 on and
              off, prefix hit %, spec accept %, chunks;
16. bf16 pools -- phase 3's requests through ``create_serving_engine``
              under ``enable_tpu_bf16`` over the default float32 pools,
              then over ``serve_kv_quant`` int8 pools (the model casts q
              to the pools' dtype at the decode kernels and the output
              back): every request completed, every token against a
              teacher-forced forward of the engine's bf16 parameters
              (over int8 pools a replay through a one-slot int8 cache
              with the plain versions; near-ties under
              ``BF16_TIE_GAP``), exact launch counts (the f32 paged-decode
              kernel, or the quantized one, once per layer per decode
              dispatch, the other never); TTFT, decode p50 and peak
              memory printed beside phase 14's bf16-over-bf16 run;
17. io     -- save, load and feed at BERT-base MLM full width on phase
              10's padded batch shape: (a) three O1 ``TrainStep`` steps
              fed by ``io.DataLoader`` (two spawned workers, batches
              through the native C++ queue, pinned copies on a side
              stream, ``prefetch_factor`` 2) over a dataset of phase 10's
              synthetic records, ``TrainStep.save``, a fresh model and
              step that ``TrainStep.load`` the file and three more steps:
              the six losses bit-equal to six uninterrupted steps from the
              same seed on the same records, with exact launch counts; the
              fed step time beside phase 10's on a resident batch and the
              seconds the consumer waited on the loader; (b) phase 12's
              f32, int8 and int8 + bf16 predictors through
              ``save_optimized_model`` and ``create_predictor(Config(
              path))``: scores bit-equal to the live predictor's with phase
              12's exact launches (74 int8 matmuls and 12 biased flash
              forwards a run, no shape fallback), each save's and load's
              seconds and the bundle's bytes; (c) an encrypted
              ``framework.save`` / ``load`` of the int8 model's state
              dict, bit-equal, and a flipped byte raises. The native
              queue's library builds with g++ into
              ``paddle_tpu_torch/_build/``; the phase prints which queue
              served;
18. monitor -- the monitor plane (``paddle_tpu_torch.monitor``,
              ``.testing.chaos``, ``.profiler``, ``.cost_model``): (a)
              phase 3's f32 engine and requests run off, then on
              (on: ``FLAGS_monitor``, ``FLAGS_trace`` at sample 1.0,
              ``FLAGS_flight_recorder``, the admin plane on an
              ephemeral 127.0.0.1 port, an availability SLO and chaos
              ``serve.request.poison@3``): the poisoned request fails
              alone with non-finite logits, the other 15 give the off
              run's tokens (near-ties under ``TIE_GAP``),
              ``serve_requests_total`` equals the scheduler's counts and
              ``serve_ttft_seconds`` counts the requests that had a
              first token, a ``/metrics`` scrape passes the exposition
              lint, ``/healthz`` and ``/readyz`` answer 200, the poisoned
              requests' traces are kept with anomaly ``chaos`` and
              exported to Perfetto, the flight ring holds
              ``request_failed``; decode p50/p99, tokens/s and the
              device busy share off and on; (b) phase 10's BERT-base
              step with each monitor feature alone and all together
              against none, then eight DataLoader-fed steps (two
              workers) under ``FLAGS_monitor``, ``FLAGS_train_goodput``,
              ``FLAGS_train_health_every=2``, ``check_numerics="warn"``,
              ``skip_nonfinite_budget=1`` and chaos ``grad.nonfinite@4``:
              the fourth step skipped with every parameter, slot and the
              step count bit-identical, one ``nonfinite_skips_total``,
              the goodput buckets summing to the run's wall time within
              1% with ``data_wait`` above 0, every
              ``train_layer_grad_norm`` finite, no ``LeakMonitor``
              growth over steps 5-8, the memory summary and census, a
              profiler window over steps 6-7 whose chrome trace names
              the hand-written kernels, and the cost model's count of
              one step (the kernel wrappers' own counts included) beside
              the analytic FLOPs, with exact launch counts;
19. resilience -- the checkpoint protocol and the serving resilience
              plane on phase 3's engine configuration (a fresh GPT-2 345M
              from seed 0): (a) phase 3's requests with every knob off,
              with phase 3's launches and tokens exactly and no
              resilience series, then off, armed (``serve_watchdog_s``
              5), armed, off, twice, with the same tokens and launches,
              decode p50 off against armed and the guarded dispatch's
              own host cost; (b) 48 requests at once (priorities 0-2, deadlines
              0.5-4 s) into a queue of 16 under the ``priority`` policy
              with the overload detector at 0.25 s, a queued and an
              in-flight cancel and a probe submit once the detector
              trips: every request one terminal outcome, offered =
              submitted + rejected, completed requests teacher-forced,
              availability and shed rate as ``bench.py`` computes them;
              (c) a drain latched after six steps, its snapshot resumed
              by a successor engine (each stream the uninterrupted
              run's, near-ties at a divergence under ``TIE_GAP``), then
              a drain torn by ``ckpt.write.torn`` whose snapshot is
              skipped; (d) ``serve.decode.hang`` under a 2 s watchdog:
              a retry-safe ``DecodeWatchdogError``, ``/readyz`` 503
              ``watchdog-tripped`` and the retried run's tokens exactly;
              (e) four adapters through ``save_adapter_checkpoint`` and
              ``load_adapter(path=)``, bit-equal to ``weights=``, and
              phase 10's BERT-base step through ``save_train_step`` /
              ``load_train_step``, bit-equal to an uninterrupted run,
              with each commit's milliseconds and bytes;
20. fleet  -- the rest of serving on GPT-2 345M (f32, random weights from
              seed 0): (a) ``models.generate`` greedy over the static
              cache, 4 prompts of 64 tokens and 32 new: exact launches (the
              flash forward once a layer for the prefill, the paged-decode
              kernel once a layer a step over the buffers read as pages),
              every token a teacher-forced forward's pick and the
              engine's greedy token (near-ties under ``TIE_GAP``),
              sampling at top-k 50 / top-p 0.9 in range and reproducible
              per seed, ms per decode step and the device busy share, row
              9 timed at this static shape; (b) ``dynamic_decode`` of a
              ``BeamSearchDecoder`` over a cell that runs the GPT over
              static caches (2 prompts, 4 beams, 16 steps; states the
              caches and position, reordered by parent): beam 1 gives
              (a)'s greedy tokens, each top score its teacher-forced
              log-probability within ``BEAM_SCORE_TOL``; (c)
              ``bench.py``'s ``serve_fleet_metrics`` (full) through 1 and
              4 replicas behind the ``FleetRouter``: parity prompts
              token-identical, measured wall tokens/s beside the JAX
              summary's busy-time model, prefix hit %, route p99,
              availability, the same with a 1 Hz ``FleetFederator``, and a
              ``kill_replica`` drill losing and duplicating nothing with
              every stream teacher-forced; (d) ``serve_lifecycle_metrics``
              (full): three identity pushes on both replicas under MMPP
              traffic (availability at least 99.9%, accounting closed), a
              torn push refused with the old weights serving, and a NaN
              candidate rolled back by the ``LifecycleController``;
21. distributed -- (a) rows 1 and 3 with dropout 0.1 over [4, 1024, 16,
              64] bf16 launched on batch rows 2-3 and heads 8-15 with
              bases (2, 8), bit-equal to the whole launches' slices (o,
              lse, dq, dk, dv) and held to their plain versions; row 8 on
              rows 2-3 of [4, 1024, 1024] from its element base, bit-equal
              to the whole launch's rows; (b) ``init_parallel_env()`` on
              the card (NCCL at world size 1) with all_reduce, all_gather,
              broadcast and barrier; then four ranks spawned on the one
              card over gloo (NCCL takes one card per rank), which load
              phase 1's libraries and build nothing: (c) float32 parity at
              dp = 2 x mp = 2 and at dp = 4, ZeRO-1 over dp, dropout 0.1,
              gpt2_medium widths at 2 layers, S = 1024, two steps: the
              losses and the gathered parameters against one process's
              TrainStep on the same weights, batch and seed; (d) the full
              gpt2_medium at dp = 2 x mp = 2, O1, recompute, ZeRO-1,
              B = 8 a call, two calls an update, four updates: losses
              finite and falling, the median update, the share of it in
              collectives (the ``comm_*`` series), peak memory per rank
              and each rank's launches exactly the formula; every rank
              checks that it imported no JAX;
22. summary -- print one JSON line describing every ported kernel, then
              the result line ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each of phases 3, 4, 7, 10, 11,
13, 14 and 15, before each engine of phase 16, before the fed run of
phase 17, before each predictor of phases 12 and 17, before each half
of phase 18, before each run of phase 19, before each part of phase
20 and, in each rank of phase 21's world, before its parity runs and
again before its timed run, and read just after each (a witness's
reference runs are taken back out of them, and phase 20 reads them
before its teacher-forced references);
the kernel JSON line gives each kernel's launches per path (``serve``,
``mt``, ``train``, ``bert``, ``ernie``, ``predict``, ``amp_int8``,
``bf16_serve``, ``chat``, ``bf16_pools``, ``io_train``, ``io_predict``,
``monitor_serve``, ``monitor_train``, ``resilience``,
``resilience_train``, ``generate``, ``beam``, ``fleet``,
``lifecycle``, ``dist``: phase 21's timed run, ``dist_parity``: its
float32 parity runs, each summed over the world's ranks).
Each phase prints its seconds, and the run its total.

Without a CUDA device, or in a directory that holds this script and
nothing else of the repository, it exits non-zero and prints no result.

``tools/run_chip_phase.py monitor|fleet|distributed`` runs phase 1 and
phase 18, 20 or 21 alone.
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
# the chat path: bench.py's serve_throughput_features (full) on SERVE_CFG,
# float32: its MMPP shared-prefix traffic, chunked prefill at 128 and
# speculative decoding at k = 4 with the radix prefix cache
CHAT_SPEC = dict(num_requests=24, rate_rps=4.0, prompt_len_range=(16, 64),
                 max_new_range=(16, 48), seed=7, arrival="mmpp",
                 burstiness=2.0, shared_prefix_len=256, prefix_pool_size=4,
                 prefix_zipf=1.2)
CHAT_FLAGS = {"serve_prefix_cache": True, "serve_prefill_chunk": 128,
              "serve_spec_k": 4}
# a teacher-forced position may pick another token than the engine only
# where the engine's token is within this of the maximum logit (a tie
# that the summation order of the paged and no-cache paths may break
# either way)
TIE_GAP = 1e-3
# the same for the bf16 engine against a no-cache forward of its own bf16
# parameters: both paths round every activation to bf16 (8 bits of
# mantissa) at other points, so their logits, near 3 at most at this
# init, differ by a few bf16 ulps (2^-6 = 0.0156 at [2, 4)); four ulps
BF16_TIE_GAP = 4 * 2.0 ** -6


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


def _context_flash_case(B, Sq, H, D, dtype, pos, seed, masked_row=None,
                        timed=False):
    """Row 2's kernel as the chat path's context prefills launch it:
    causal with a key bias at Sq < Sk = SERVE_CFG's 512-token context,
    each row's positions ``0 .. pos + Sq - 1`` right-aligned and the
    left padding at ``-1e30`` (``serving.kv_cache.context_index``); with
    ``masked_row`` that batch row's every key is masked (a padded row),
    which must give o = 0 and lse = -1e30. o within ``TOL`` of the plain
    version (in bf16 also of the one that rounds pv as the kernel does),
    lse within ``10 * TOL["float32"]``, two launches bit-equal; timed
    against SDPA given the same mask as one float ``[B, 1, Sq, Sk]``
    tensor."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import NEG_INF
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    Sk = SERVE_CFG["max_context_len"]
    bias = torch.zeros(B, Sk)
    for b, p in enumerate(pos):
        bias[b, :Sk - Sq - p] = NEG_INF
    if masked_row is not None:
        bias[masked_row] = NEG_INF
    bias = bias.cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(B, Sk, H, D, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, True, None, True)
    again = fa.flash_attention_bias_fwd(q, k, v, bias, True, None, True)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, True, None, True,
                                              bias=bias)
    torch.cuda.synchronize()
    equal = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    err = _abs_err(o, o_ref)
    live = [b for b in range(B) if b != masked_row]
    lse_err = (lse[live] - lse_ref[live]).abs().max().item()
    name = _name(dtype)
    mxu = _mxu_errs((o,), lambda: (fa.flash_attention_plain(
        q, k, v, True, bias=bias, mxu_dtype=torch.bfloat16),), dtype,
        _abs_err)
    shape = (f"B={B} Sq={Sq} Sk={Sk} H={H} D={D} {name} causal, key bias, "
             f"pos {list(pos)}"
             + (f", row {masked_row} fully masked"
                if masked_row is not None else ""))
    _log(f"kernels: flash_attention_bias_fwd context [{shape}]: "
         f"max|o-plain| {err:.3e}, max|lse-plain| {lse_err:.3e} (tol "
         f"{TOL[name]:g}); two launches bit-equal {equal}"
         + _mxu_note(mxu, ("max|o-plain|",)))
    _require(math.isfinite(err) and max([err] + mxu) <= TOL[name]
             and lse_err <= TOL["float32"] * 10,
             f"the causal biased forward at Sq={Sq} < Sk={Sk} disagrees "
             f"with its plain version in {name}: {err}, against bf16 MXU "
             f"operands {mxu}, lse {lse_err}")
    _require(equal, "two launches of the causal biased forward differ")
    if masked_row is not None:
        _require(bool((o[masked_row] == 0).all())
                 and bool((lse[masked_row] == NEG_INF).all()),
                 "a fully masked context row did not give o = 0, "
                 "lse = -1e30")
    if not timed:
        return None
    ms = _median_ms(lambda: fa.flash_attention_bias_fwd(q, k, v, bias,
                                                        True))
    plain_ms = _median_ms(lambda: fa.flash_attention_plain(
        q, k, v, True, bias=bias), iters=5, warmup=1)
    causal = torch.ones(Sq, Sk, dtype=torch.bool,
                        device="cuda").tril(Sk - Sq)
    mask = (bias[:, None, None, :]
            + torch.where(causal, 0.0, NEG_INF)).to(dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    # what this data needs: query row i of row b sees pos_b + i + 1
    # keys, so K and V are read over each row's pos_b + Sq visible
    # columns only (the left padding is masked), q read and o written
    # once, and the bias read whole
    pairs = H * sum(Sq * (p + 1) + Sq * (Sq - 1) // 2 for p in pos)
    elem = q.element_size()
    visible = sum(min(p + Sq, Sk) for b, p in enumerate(pos)
                  if b != masked_row)
    bound, by = _bound_ms(2 * H * D * elem * visible
                          + 2 * B * Sq * H * D * elem + B * Sk * 4,
                          4 * D * pairs, "float32_3xtf32"
                          if name == "float32" else name)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "shape": shape}


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
    # rows printed beside the JSON line's: the serving path's f32 and
    # bf16 engines (phases 3 and 14) time rows 1 and 9 in both dtypes
    more_rows = {"flash_attention_fwd bfloat16 serve": _flash_case(
        4, 256, 16, 64, torch.bfloat16, seed=256, timed=True)}
    more_rows["flash_attention_fwd float32"] = _flash_case(
        4, 256, 16, 64, torch.float32, seed=256, timed=True)
    more_rows["paged_decode_attention bfloat16"] = _paged_case(
        torch.bfloat16, seed=1, timed=True)
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
        more_rows["flash_attention_bias_fwd float32"
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
    # the chat path's context prefills: chunks and prefix-hit tails (Sq =
    # 128) and verify windows (Sq = 5) over the 512-token context, row 0
    # at pos 0 (its first query sees one key), a padded row fully masked;
    # the row times a prefix-hit tail of the 256-token system prompt
    for dtype in (torch.float32, torch.bfloat16):
        _context_flash_case(5, 128, 16, 64, dtype, (0, 128, 256, 384, 0),
                            seed=21, masked_row=4)
        _context_flash_case(5, 5, 16, 64, dtype, (0, 131, 300, 507, 0),
                            seed=22, masked_row=4)
    more_rows["flash_attention_bias_fwd float32 context"] = \
        _context_flash_case(4, 128, 16, 64, torch.float32, (256,) * 4,
                            seed=23, timed=True)
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
    for name, r in {**rows, **more_rows, **bgmv_cases, **int8_cases}.items():
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
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    _log(f"slice: gpt2_medium ({sum(p.numel() for p in model.parameters())}"
         f" parameters, {cfg.num_layers} layers) and engine ready in "
         f"{time.perf_counter() - t0:.2f} s; {n_kernels} kernels loaded; "
         f"config {engine.config.prefill_buckets} x "
         f"{engine.config.batch_buckets}, {engine.config.num_pages} pages")
    specs = _slice_specs(cfg.vocab_size)

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

    peak = (build_peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    _teacher_forced("slice", model, states, TIE_GAP)
    _log(f"slice: {_serve_line(summary, peak)}")
    busy = _profile_serve("slice", engine, specs)
    return launches, {"summary": summary, "peak": peak, "busy": busy,
                      "tokens": [st.generated for st in states]}


def _slice_specs(vocab_size):
    """Phase 3's 16 greedy requests: (prompt, max_new_tokens), seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    specs = []
    for _ in range(NUM_REQUESTS):
        n = int(rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1))
        new = int(rng.randint(NEW_TOKENS_RANGE[0], NEW_TOKENS_RANGE[1] + 1))
        specs.append((rng.randint(0, vocab_size, (n,)), new))
    return specs


def _teacher_forced(tag, model, states, tie_gap, params=None):
    """A no-cache forward over prompt + generated (of ``params``, the
    engine's parameter copy, when given) must pick every generated
    token, up to near-ties: where it picks another one, the engine's
    token must lie within ``tie_gap`` of the maximum logit. Returns the
    tokens checked."""
    import numpy as np
    import torch
    from torch.func import functional_call
    ties, checked, worst_gap = 0, 0, 0.0
    with torch.no_grad():
        for st in states:
            seq = np.concatenate([st.request.prompt,
                                  np.asarray(st.generated, np.int32)])
            ids = torch.from_numpy(seq[None].astype(np.int64)).cuda()
            out = (model(ids) if params is None else functional_call(
                model, params, (ids,)))
            logits = out[0].float()                            # [S, V]
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
    _log(f"{tag}: teacher-forced check over {checked} generated tokens: "
         f"{ties} positions pick another token, largest logit gap there "
         f"{worst_gap:.3e} (allowed < {tie_gap:g})")
    _require(worst_gap < tie_gap,
             f"{tag}: teacher-forced forward disagrees with the engine by a "
             f"logit gap of {worst_gap} >= {tie_gap}")
    return checked


def _ms(x):
    return "n/a" if x is None else f"{x * 1e3:.3f} ms"


def _serve_line(summary, peak) -> str:
    """``peak``: the device memory peaks (GiB) of the build and warm-up
    (the model, the engine's parameter copy, the pools) and of the
    serving run after it."""
    return (f"{summary['tokens_per_sec']:.2f} tokens/s, TTFT p50 "
            f"{_ms(summary['ttft_p50_s'])} p99 {_ms(summary['ttft_p99_s'])}"
            f", decode step p50 {_ms(summary['decode_step_p50_s'])} p99 "
            f"{_ms(summary['decode_step_p99_s'])}, mean decode occupancy "
            f"{summary['mean_decode_occupancy']:.3f}, peak device memory "
            f"{max(peak):.3f} GiB (build {peak[0]:.3f}, serving "
            f"{peak[1]:.3f})")


def _profile_serve(tag, engine, specs) -> float:
    """The device busy share of one more run of ``specs`` through
    ``engine`` under torch.profiler (``_profile_step``); its launches
    are not read by any count."""
    from paddle_tpu_torch.serving import Request, SamplingParams

    def run():
        for p, new in specs:
            engine.submit(Request(p, max_new_tokens=new,
                                  sampling=SamplingParams()))
        engine.run()
    return _profile_step(f"{tag} profile", run)


# -- phase 14: bf16 serving ---------------------------------------------------
def _layer_norm_one_launch(params: dict, E: int) -> None:
    """``nn.functional.layer_norm`` on bf16 input with the bf16 copy's
    weight and bias takes PyTorch's one-launch kernel on the card; it
    must equal the float32 casts it replaces bit for bit at the decode
    and prefill shapes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.nn import functional as pf
    w = params["gpt.layers.0.ln1.weight"]
    b = params["gpt.layers.0.ln1.bias"]
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        # the model's unit scale and zero shift, perturbed
        w, b = ((t + 0.1 * torch.randn(E, device="cuda", generator=g))
                .to(t.dtype) for t in (w, b))
        for shape in ((8, 1, E), (4, 256, E)):
            x = (3 * torch.randn(*shape, device="cuda", generator=g)
                 + 0.5).to(torch.bfloat16)
            one = pf.layer_norm(x, E, w, b)
            cast = F.layer_norm(x.float(), (E,), w.float(), b.float(),
                                1e-5).to(x.dtype)
            _require(one.dtype == torch.bfloat16 and torch.equal(one, cast),
                     f"bf16 layer norm's one launch differs from the f32 "
                     f"casts at {shape}: "
                     f"{(one.float() - cast.float()).abs().max().item()}")
    _log("bf16: layer norm's one-launch kernel equals the f32 casts bit "
         "for bit at [8, 1, E] and [4, 256, E]")


def phase_bf16_serve(f32: dict) -> dict:
    """Phase 3's 16 greedy requests through ``create_serving_engine`` on a
    bf16 parameter copy over bf16 pools: exact launch counts, every
    token against a teacher-forced no-cache forward of the same bf16
    copy, KV bytes a token half of f32's, and phase 3's f32 numbers
    printed beside the bf16 ones."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Request, SamplingParams, ServingConfig
    cfg = gpt2_medium()
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    config = inference.Config.from_layer(model, [])
    config.enable_tpu_bf16()
    engine = inference.create_serving_engine(
        config, ServingConfig(**SERVE_CFG, cache_dtype="bfloat16"),
        device="cuda")
    dtypes = {p.dtype for p in engine.params.values()}
    _require(dtypes == {torch.bfloat16}
             and engine.cache.k.dtype == torch.bfloat16
             and engine.cache.v.dtype == torch.bfloat16
             and all(p.dtype == torch.float32 for p in model.parameters()),
             f"bf16 engine: parameters {dtypes}, pools {engine.cache.k.dtype}"
             ", or the layer was cast")
    _layer_norm_one_launch(engine.params, cfg.hidden_size)
    engine.warmup()
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    specs = _slice_specs(cfg.vocab_size)
    kernels.reset_launch_counts()
    states = [engine.submit(Request(p, max_new_tokens=new,
                                    sampling=SamplingParams()))
              for p, new in specs]
    engine.run()
    torch.cuda.synchronize()
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    stats = engine.stats()
    summary = engine.metrics_summary()
    peak = (build_peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    for st, (p, new) in zip(states, specs):
        _require(st.outcome == "completed" and len(st.generated) == new,
                 f"bf16: request {st.request.request_id} ended {st.outcome}"
                 f" with {len(st.generated)} of {new} tokens")
    n_pre, n_dec = stats["prefill_dispatches"], stats["decode_dispatches"]
    _log(f"bf16: {len(states)} requests, {stats['tokens_generated']} "
         f"tokens, {n_pre} prefill and {n_dec} decode dispatches; launches "
         f"{launches}")
    _require(launches["flash_attention_fwd"] >= L * n_pre > 0,
             f"bf16: flash launches {launches['flash_attention_fwd']} < "
             f"{L} x {n_pre} prefill dispatches")
    _require(launches["paged_decode_attention"] == L * n_dec > 0,
             f"bf16: paged-decode launches "
             f"{launches['paged_decode_attention']} != {L} x {n_dec}")
    kv, kv32 = summary["kv_bytes_per_token"], \
        f32["summary"]["kv_bytes_per_token"]
    _require(kv == 2 * L * cfg.num_heads * cfg.head_dim * 2 == kv32 // 2,
             f"bf16 KV costs {kv} bytes a token (f32 {kv32})")
    _teacher_forced("bf16", model, states, BF16_TIE_GAP,
                    params={**engine.params, **engine.buffers})
    _log(f"bf16: {_serve_line(summary, peak)}; KV {kv} bytes a token")
    _log(f"bf16: f32 (phase 3) {_serve_line(f32['summary'], f32['peak'])};"
         f" KV {kv32} bytes a token")
    busy = _profile_serve("bf16", engine, specs)
    _log(f"bf16: device busy share of one profiled run {100 * busy:.2f}% "
         f"(f32, phase 3: {100 * f32['busy']:.2f}%)")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"summary": summary, "peak": peak}


# -- phase 15: chat serving --------------------------------------------------
def _capture_submits(engine) -> list:
    """Every state ``engine.submit`` returns from now on, in order (the
    open-loop driver keeps them to itself)."""
    states = []
    submit = engine.submit

    def keep(request):
        st = submit(request)
        states.append(st)
        return st
    engine.submit = keep
    return states


def phase_chat() -> dict:
    """``bench.py``'s ``serve_throughput_features`` at full size: the
    chat traffic (a 256-token system prompt of four, zipf reuse, MMPP
    arrivals) served by the flags-off engine and by one with the radix
    prefix cache, chunked prefill at 128 and speculative decoding at
    k = 4, f32 as the bench runs it. The parity prompts token-identical
    between the two, every request completed, every generated token a
    teacher-forced pick, exact launch counts, and every page's
    refcount back to the tree's references at the end."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (LoadSpec, ServingConfig,
                                          ServingEngine, run_open_loop)
    cfg = gpt2_medium()
    L = cfg.num_layers
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    chat = LoadSpec(**CHAT_SPEC, vocab_size=cfg.vocab_size)
    # bench.py's parity prompts: a shared-prefix pair and a
    # self-repetitive tail
    rng = np.random.default_rng(11)
    pre = rng.integers(0, cfg.vocab_size, (32,)).tolist()
    parity = [pre + rng.integers(0, cfg.vocab_size, (8,)).tolist(),
              pre + rng.integers(0, cfg.vocab_size, (5,)).tolist(),
              [3, 4, 5, 3, 4, 5, 3, 4]]
    engines = {}
    for tag, flags in (("off", {}), ("on", CHAT_FLAGS)):
        with contextlib.ExitStack() as stack:
            for name, value in flags.items():
                stack.enter_context(flag_scope(name, value))
            engines[tag] = ServingEngine(model, ServingConfig(**SERVE_CFG),
                                         device="cuda")
        engines[tag].warmup()
    kernels.reset_launch_counts()
    out, runs = {}, {}
    for tag, eng in engines.items():
        out[tag] = [o[-8:].tolist() for o in eng.generate(
            parity, max_new_tokens=8)]
        states = _capture_submits(eng)
        # the prefix tree warm as production's is: a burst of the same
        # seed's traffic first, in both engines
        run_open_loop(eng, dataclasses.replace(
            chat, num_requests=chat.prefix_pool_size, rate_rps=1e6))
        tok0, n_ttft0 = eng.stats()["tokens_generated"], len(eng._lat["ttft"])
        t0 = time.perf_counter()
        summary = run_open_loop(eng, chat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ttft = eng._lat["ttft"][n_ttft0:]
        runs[tag] = {"summary": summary, "states": states,
                     "tps": (eng.stats()["tokens_generated"] - tok0) / wall,
                     "ttft99": float(np.percentile(ttft, 99))}
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    st_on, st_off = engines["on"].stats(), engines["off"].stats()
    n_ctx = n_fresh = n_plain = 0
    for st_ in (st_on, st_off):
        n_ctx += st_["context_prefill_dispatches"] + st_["verify_dispatches"]
        n_fresh += st_["prefill_dispatches"] \
            - st_["context_prefill_dispatches"]
        n_plain += st_["decode_dispatches"] - st_["verify_dispatches"]
    _log(f"chat: {n_fresh} fresh and {st_on['context_prefill_dispatches']} "
         f"context prefill, {st_on['verify_dispatches']} verify and "
         f"{n_plain} decode dispatches over both engines; launches "
         f"{launches}")
    _require(launches["flash_attention_bias_fwd"] == L * n_ctx > 0,
             f"chat: causal biased flash launches "
             f"{launches['flash_attention_bias_fwd']} != {L} x {n_ctx} "
             "context prefill and verify dispatches")
    _require(launches["flash_attention_fwd"] == L * n_fresh > 0,
             f"chat: flash launches {launches['flash_attention_fwd']} != "
             f"{L} x {n_fresh} fresh prefill dispatches")
    _require(launches["paged_decode_attention"] == L * n_plain > 0,
             f"chat: paged-decode launches "
             f"{launches['paged_decode_attention']} != {L} x {n_plain} "
             "decode dispatches")
    # parity: token-identical up to a near-tie at the first divergence
    # of a prompt, whose gap a no-cache forward of the off stream reads
    ties, worst = 0, 0.0
    with torch.no_grad():
        for p, a, b in zip(parity, out["off"], out["on"]):
            d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if d is None:
                continue
            seq = torch.tensor([p + a[:d]], device="cuda")
            row = model(seq)[0, -1].float()
            ties += 1
            worst = max(worst, abs(float(row[a[d]] - row[b[d]])))
    _log(f"chat: parity prompts off {out['off']} on {out['on']}: {ties} "
         f"diverge, at a logit gap of at most {worst:.3e} (allowed < "
         f"{TIE_GAP:g})")
    _require(worst < TIE_GAP, f"chat: the features change greedy tokens "
             f"beyond a near-tie (gap {worst})")
    checked = 0
    for tag, run in runs.items():
        done = [st for st in run["states"] if st.outcome == "completed"]
        _require(len(run["states"]) == chat.prefix_pool_size
                 + chat.num_requests == len(done),
                 f"chat ({tag}): {len(done)} of {len(run['states'])} "
                 "requests completed")
        checked += _teacher_forced(f"chat ({tag})", model, run["states"],
                                   TIE_GAP)
    pc = engines["on"].prefix_cache
    alloc = engines["on"].cache.allocator
    _require(alloc.pages_in_use == pc.cached_pages
             and all(alloc.refcount(p) == 1 for p in pc._nodes),
             f"chat: {alloc.pages_in_use} pages in use, the tree holds "
             f"{pc.cached_pages}")
    s_on, s_off = runs["on"]["summary"], runs["off"]["summary"]
    _log(f"chat: tokens/s {runs['off']['tps']:.2f} off, "
         f"{runs['on']['tps']:.2f} on; TTFT p99 "
         f"{runs['off']['ttft99'] * 1e3:.3f} ms off, "
         f"{runs['on']['ttft99'] * 1e3:.3f} ms on; prefix hit "
         f"{s_on['prefix_hit_pct']:.2f}% ({s_on['prefix_hit_tokens']} "
         f"tokens); spec accept "
         + ("n/a" if s_on["spec_accept_pct"] is None
            else f"{s_on['spec_accept_pct']:.2f}%")
         + f" ({s_on['spec_accepted']} accepted of {s_on['spec_proposed']}"
         f" proposed, {s_on['spec_rolled_back']} rolled back); "
         f"{s_on['prefill_chunks']} chunks; decode step p50/p99 "
         f"{_ms(s_off['decode_step_p50_s'])}/"
         f"{_ms(s_off['decode_step_p99_s'])} off, "
         f"{_ms(s_on['decode_step_p50_s'])}/"
         f"{_ms(s_on['decode_step_p99_s'])} on; {pc.cached_pages} pages "
         f"cached, their refcounts the tree's")
    for eng in engines.values():
        eng.shutdown()
    del engines, model
    gc.collect()
    torch.cuda.empty_cache()
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


def _mt_replay(model, engine, states, tag="mt", tie_gap=TIE_GAP,
               params=None) -> None:
    """Teacher-forced replay of every request through the paged path
    with the plain versions: a one-slot int8 cache and the request's
    adapter row (when the engine has LoRA pools), the prompt prefilled
    at the engine's length bucket, then one S=1 decode step for each
    generated token but the last, feeding the engine's tokens; of
    ``params`` (the engine's parameter copy) when given. Every
    generated token must be the replay's argmax or within ``tie_gap``
    of its largest logit."""
    import numpy as np
    import torch
    from torch.func import functional_call
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
    def fwd(ids, **kw):
        return model(ids, **kw) if params is None else \
            functional_call(model, params, (ids,), kw)

    lora = engine.lora
    before = sum(k["launches"] for k in kernels.kernels())
    ties, checked, worst_gap = 0, 0, 0.0
    with torch.no_grad(), _plain_versions():
        for st in states:
            prompt, gen = st.request.prompt, st.generated
            P = prompt.size
            _require(cache.alloc_slot(0, P + len(gen)), "replay cache full")
            view = PagedCacheView(
                cache.k, cache.v, cache.table_array([0]), cache.k_scale,
                cache.v_scale, *((lora.a, lora.b,
                                  lora.rows_for([st.request.adapter]))
                                 if lora is not None else ()))
            ids = np.zeros((1, engine.buckets.len_bucket(P)), np.int64)
            ids[0, :P] = prompt
            zero = torch.zeros(1, dtype=torch.int32, device="cuda")
            preds = [fwd(torch.from_numpy(ids).cuda(), caches=view,
                         cache_pos=zero)[0, P - 1]]
            for i, tok in enumerate(gen[:-1]):
                pos = torch.tensor([P + i], dtype=torch.int32,
                                   device="cuda")
                preds.append(fwd(torch.tensor([[tok]], device="cuda"),
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
    adapters = ", each request's adapter" if lora is not None else ""
    _log(f"{tag}: teacher-forced replay (plain versions, one-slot int8 "
         f"cache{adapters}) over {checked} generated "
         f"tokens: {ties} positions pick another token, largest logit "
         f"gap there {worst_gap:.3e} (allowed < {tie_gap:g})")
    _require(worst_gap < tie_gap,
             f"{tag}: the replay disagrees with the engine by a logit gap "
             f"of {worst_gap} >= {tie_gap}")


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
              lambda q, k, v, *a, **kw: fa.flash_attention_plain(
                  q, k, v, *a, mxu_dtype=op(q), **kw)),
             (fa, "flash_attention_bwd",
              lambda q, k, v, o, lse, do, *a, **kw:
              fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *a,
                                           mxu_dtype=op(q), **kw)),
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


def _profile_step(tag: str, fn) -> float:
    """Device time by kernel over one more call of ``fn`` (a step or a
    predictor run; torch.profiler), as ``tools/profile_torch_serve.py``
    reads it. Returns the device busy share of the call (summed kernel
    time over its wall time; one stream, so kernels never overlap)."""
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
    return busy / (wall * 1e3)


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
    return launches, step_s


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
# phase 17's DataLoader-fed BERT steps before and after the resume
IO_STEPS = 3
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


# -- phase 16: bf16 parameters over f32 and int8 pools -----------------------
def phase_bf16_pools(bf16: dict) -> dict:
    """Phase 3's requests through ``create_serving_engine`` under
    ``enable_tpu_bf16`` over the default float32 pools, then over
    ``serve_kv_quant`` int8 pools: every request completes, every token
    is checked (over f32 pools against a teacher-forced no-cache forward
    of the engine's bf16 parameters, over int8 pools against the same
    replay through a one-slot int8 cache with the plain versions; near-
    ties under ``BF16_TIE_GAP``), and the launches are exact: the f32
    paged-decode kernel (row 9) or the quantized one (row 10) once a
    layer per decode dispatch, the other never. TTFT, decode p50 and
    peak memory are printed beside phase 14's bf16-over-bf16 run."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Request, SamplingParams, ServingConfig
    cfg = gpt2_medium()
    L = cfg.num_layers
    specs = _slice_specs(cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    _log(f"bf16 pools: {held:.3f} GiB held before the phase, "
         f"{torch.cuda.memory_allocated() / 2 ** 30 - held:.3f} GiB the "
         f"f32 model")
    total = {k.name: 0 for k in kernels.KERNELS.values()}
    for pools in ("float32", "int8"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        config = inference.Config.from_layer(model, [])
        config.enable_tpu_bf16()
        with contextlib.ExitStack() as stack:
            if pools == "int8":
                stack.enter_context(flag_scope("serve_kv_quant", "int8"))
            engine = inference.create_serving_engine(
                config, ServingConfig(**SERVE_CFG), device="cuda")
        want_pool = torch.int8 if pools == "int8" else torch.float32
        _require({p.dtype for p in engine.params.values()}
                 == {torch.bfloat16} and engine.cache.k.dtype == want_pool,
                 f"bf16 over {pools}: pools {engine.cache.k.dtype}")
        engine.warmup()
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        states = [engine.submit(Request(p, max_new_tokens=new,
                                        sampling=SamplingParams()))
                  for p, new in specs]
        engine.run()
        torch.cuda.synchronize()
        launches = {k["name"]: k["launches"] for k in kernels.kernels()}
        for k, n in launches.items():
            total[k] += n
        stats = engine.stats()
        summary = engine.metrics_summary()
        peak = (build_peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        for st, (p, new) in zip(states, specs):
            _require(st.outcome == "completed" and len(st.generated) == new,
                     f"bf16 over {pools}: request {st.request.request_id} "
                     f"ended {st.outcome} with {len(st.generated)} of {new}"
                     " tokens")
        n_pre, n_dec = stats["prefill_dispatches"], \
            stats["decode_dispatches"]
        row, other = (("paged_decode_attention_quant",
                       "paged_decode_attention") if pools == "int8" else
                      ("paged_decode_attention",
                       "paged_decode_attention_quant"))
        _log(f"bf16 over {pools}: {len(states)} requests, "
             f"{stats['tokens_generated']} tokens, {n_pre} prefill and "
             f"{n_dec} decode dispatches; launches {launches}")
        _require(launches[row] == L * n_dec > 0 and launches[other] == 0,
                 f"bf16 over {pools}: {row} launched {launches[row]} != "
                 f"{L} x {n_dec}, {other} {launches[other]} != 0")
        _require(launches["flash_attention_fwd"] >= L * n_pre > 0,
                 f"bf16 over {pools}: flash launches "
                 f"{launches['flash_attention_fwd']} < {L} x {n_pre}")
        params = {**engine.params, **engine.buffers}
        if pools == "int8":
            _mt_replay(model, engine, states, tag="bf16 over int8",
                       tie_gap=BF16_TIE_GAP, params=params)
        else:
            _teacher_forced("bf16 over float32", model, states,
                            BF16_TIE_GAP, params=params)
        _log(f"bf16 over {pools}: {_serve_line(summary, peak)}; KV "
             f"{summary['kv_bytes_per_token']} bytes a token")
        del engine, params, states
        gc.collect()
        torch.cuda.empty_cache()
    _log(f"bf16 over bfloat16 (phase 14): "
         f"{_serve_line(bf16['summary'], bf16['peak'])}; KV "
         f"{bf16['summary']['kv_bytes_per_token']} bytes a token")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return total


# -- phase 17: save, load and feed ----------------------------------------------
class _Records:
    """Phase 10's synthetic padded pretraining records, one batch of
    ``BERT_B`` rows from each seed, as a map-style dataset of the port's
    ``io`` (a top-level class: the DataLoader's spawned workers unpickle
    it)."""

    def __init__(self, seeds, vocab_size):
        import numpy as np
        parts = [pretraining_batch(BERT_B, BERT_S, BERT_M, vocab_size,
                                   seed=s)[0] for s in seeds]
        self.arrays = [np.concatenate(a) for a in zip(*parts)]

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


def _bytes(prefix: str) -> int:
    return sum(os.path.getsize(prefix + ext)
               for ext in (".pdiparams", ".pdmodel.meta"))


def _io_train(tmp: str, bert_step_s: float) -> dict:
    """Three O1 BERT-base steps fed by ``io.DataLoader`` (two workers,
    pinned copies, ``prefetch_factor`` 2), ``TrainStep.save``, then a
    fresh model and step that ``TrainStep.load`` the file and take three
    more from the same loader: the six losses must equal six
    uninterrupted steps from the same seed on the same records bit for
    bit."""
    import numpy as np
    import torch
    from paddle_tpu_torch import io
    from paddle_tpu_torch.ops import kernels
    records = _Records(range(2 * IO_STEPS), 30528)
    ref = []
    cfg, _, step, _ = _encoder_setup("bert")
    for b in range(2 * IO_STEPS):
        rows = range(b * BERT_B, (b + 1) * BERT_B)
        batch = io.default_collate_fn([records[i] for i in rows])
        ref.append(float(step(*batch)))
    del step
    gc.collect()
    torch.cuda.empty_cache()

    loader = io.DataLoader(records, batch_size=BERT_B, num_workers=2,
                           prefetch_factor=2, places="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    it = iter(loader)
    first_wait = time.perf_counter() - t0
    queue = "native C++ queue" if it.inner._native_q is not None \
        else "multiprocessing queue (g++ build failed)"
    losses, waits, steps = [], [], []
    _, _, step, _ = _encoder_setup("bert")
    path = os.path.join(tmp, "bert_step.pd")
    for half in range(2):
        if half == 1:
            t = time.perf_counter()
            step.save(path)
            save_s = time.perf_counter() - t
            del step
            gc.collect()
            _, _, step, _ = _encoder_setup("bert")
            t = time.perf_counter()
            step.load(path)
            load_s = time.perf_counter() - t
            _require(step.step_count == IO_STEPS,
                     f"resumed at step {step.step_count}")
        for _ in range(IO_STEPS):
            t = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            losses.append(float(step(*batch)))      # syncs on the loss
            waits.append(t1 - t)
            steps.append(time.perf_counter() - t)
    with contextlib.suppress(StopIteration):
        next(it)
        raise RuntimeError("the loader gave more batches than records")
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    want = _encoder_launches(cfg, 2 * IO_STEPS)
    _log(f"io train: losses fed/resumed " + " ".join(f"{x:.6f}" for x in
                                                     losses))
    _log(f"io train: losses uninterrupted " + " ".join(f"{x:.6f}" for x in
                                                       ref))
    _require(losses == ref, "the resumed DataLoader-fed run differs from "
             "the uninterrupted one")
    _require(launches == want, f"io train: launches {launches} != {want}")
    nbytes = os.path.getsize(path)
    _log(f"io train: six losses bit-equal to the uninterrupted run; batches "
         f"through the {queue}; TrainStep.save {save_s:.3f} s, load "
         f"{load_s:.3f} s, {nbytes} bytes")
    warm = [s for i, s in enumerate(steps) if i % IO_STEPS]
    _log(f"io train: DataLoader-fed step (steps 2-3 and 5-6, consumer wait "
         f"included) median {np.median(warm) * 1e3:.2f} ms, min "
         f"{min(warm) * 1e3:.2f} ms; phase 10 resident batch "
         f"{bert_step_s * 1e3:.2f} ms/step; consumer waited on the loader "
         f"{sum(waits):.4f} s over {len(waits)} batches (per batch "
         + " ".join(f"{w * 1e3:.2f}" for w in waits)
         + f" ms) and {first_wait:.3f} s for the first fill (two spawned "
         f"workers)")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _io_predict(tmp: str) -> dict:
    """Phase 12's f32, int8 and int8 + bf16 predictors saved with
    ``save_optimized_model`` and loaded with ``create_predictor(Config(
    path))``: the loaded predictor's scores equal the live one's bit for
    bit, with phase 12's exact launches; then an encrypted
    ``framework.save`` / ``load`` round trip of the int8 model's state
    dict, bit-equal, and a flipped byte of the file raises."""
    import numpy as np
    import torch
    from paddle_tpu_torch import framework, inference
    from paddle_tpu_torch.framework.crypto import DecryptionError
    from paddle_tpu_torch.ops import kernels
    batch, _ = pretraining_batch(BERT_B, BERT_S, BERT_M, 30528)
    inputs = list(batch[:4])
    n_lin, L = 74, 12
    total = {k.name: 0 for k in kernels.KERNELS.values()}
    for kind in ("f32", "int8", "int8+bf16"):
        pred, layer = _predictor(kind)
        live = pred.run(inputs)[0]
        path = os.path.join(tmp, kind.replace("+", "_"))
        t = time.perf_counter()
        pred.save_optimized_model(path)
        save_s = time.perf_counter() - t
        state = None
        if kind == "int8":
            state = {k: v.detach().clone() for k, v in
                     layer.state_dict().items()}
        del pred, layer
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        loaded = inference.create_predictor(
            inference.Config(path, device="cuda"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        kernels.reset_launch_counts()
        out = loaded.run(inputs)[0]
        launches = {k["name"]: k["launches"] for k in kernels.kernels()}
        want = {k: 0 for k in launches}
        want["flash_attention_bias_fwd"] = L
        want["int8_matmul"] = 0 if kind == "f32" else n_lin
        _require(launches == want and not kernels.FALLBACKS,
                 f"io predict {kind}: launches {launches} != {want}, shape "
                 f"fallbacks {kernels.FALLBACKS}")
        for k, n in launches.items():
            total[k] += n
        _require(np.array_equal(out, live),
                 f"io predict {kind}: the loaded predictor differs from the "
                 f"live one by {np.abs(out - live).max()}")
        _log(f"io predict {kind}: Config(path) scores bit-equal to the live "
             f"predictor's; launches int8_matmul {launches['int8_matmul']}, "
             f"flash_attention_bias_fwd "
             f"{launches['flash_attention_bias_fwd']}, no shape fallback; "
             f"save_optimized_model {save_s:.3f} s, load (Config(path) + "
             f"create_predictor) {load_s:.3f} s, bundle {_bytes(path)} bytes")
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        if state is not None:
            key = bytes(range(32))
            enc = os.path.join(tmp, "int8_state.pd")
            t = time.perf_counter()
            framework.save(state, enc, encryption_key=key)
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            back = framework.load(enc, encryption_key=key)
            load_s = time.perf_counter() - t
            _require(set(back) == set(state) and all(
                np.array_equal(back[k], framework.io.to_numpy(v))
                for k, v in state.items()),
                "the encrypted round trip changed the state dict")
            with open(enc, "r+b") as f:
                f.seek(os.path.getsize(enc) // 2)
                byte = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([byte[0] ^ 1]))
            try:
                framework.load(enc, encryption_key=key)
            except DecryptionError:
                tampered = "raised DecryptionError"
            else:
                raise RuntimeError("a flipped byte of an encrypted file "
                                   "loaded without error")
            _log(f"io crypto: the int8 model's state dict ({len(state)} "
                 f"tensors, {os.path.getsize(enc)} bytes encrypted) round "
                 f"trips bit-equal: save {save_s:.3f} s, load "
                 f"{load_s:.3f} s; a flipped byte {tampered}")
            del state, back
    return total


def phase_io(bert_step_s: float):
    """Save, load and feed at BERT-base MLM full width with phase 10's
    padded batch shape: a DataLoader-fed training run resumed from
    ``TrainStep.save``, predictors from disk, an encrypted state dict.
    Returns the launches of the fed run and of the loaded predictors."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        train = _io_train(tmp, bert_step_s)
        predict = _io_predict(tmp)
    return train, predict


# -- phase 18: the monitor plane ------------------------------------------------
# the hand-written kernels phase 19's profiler window must name (rows 2,
# 4, 5, 6, 7, 8 in bf16 at BERT-base O1): their __global__ functions
MONITOR_TRAIN_KERNELS = ("flash_fwd_tc_kernel", "dq_tc_kernel",
                         "dkv_tc_kernel", "lse_kernel", "dlogits_kernel",
                         "dropout_kernel")
MONITOR_TRAIN_STEPS = 8
# timed steps a configuration in the per-feature step-time table, and
# the table's passes (forward order; a second pass would run in reverse)
FEATURE_STEPS = 4
FEATURE_PASSES = 1
# the serving "all on" run's flags (its admin plane on an ephemeral
# 127.0.0.1 port), read when the engine is built and at every submit
MONITOR_SERVE_FLAGS = {"monitor": True, "trace": True, "trace_sample": 1.0,
                       "flight_recorder": True, "monitor_port": -1}
# the serving runs off and all on: one a side (one engine's runs spread
# by 10-20% on this host, more than telemetry's cost, so
# tools/time_monitor_serve.py takes more runs a side where that matters)
MONITOR_SERVE_ORDER = ("off", "on")


@contextlib.contextmanager
def _flags(flags: dict):
    from paddle_tpu_torch.core import flag_scope
    with contextlib.ExitStack() as stack:
        for name, value in flags.items():
            stack.enter_context(flag_scope(name, value))
        yield


def _monitor_serve_run(engine, specs, on: bool):
    """One run of phase 3's requests through ``engine``: with ``on`` the
    monitor flags set and the third request poisoned. Returns the
    states, the summary, the run's registry, the scheduler's counts of
    the run and, for an on run, the admin plane's answers after it
    (``_scrape``; the server reads the run's registry)."""
    from paddle_tpu_torch.monitor import scoped_registry
    from paddle_tpu_torch.serving import Request, SamplingParams
    from paddle_tpu_torch.testing import chaos
    before = dict(engine.scheduler.stats)
    with _flags(MONITOR_SERVE_FLAGS if on else {}), \
            scoped_registry() as reg:
        if on:
            chaos.configure("serve.request.poison@3", seed=0)
        # this run's latencies only
        engine._lat = {k: [] for k in engine._lat}
        engine._t_first_work = engine._t_last_token = None
        states = [engine.submit(Request(p, max_new_tokens=new,
                                        sampling=SamplingParams()))
                  for p, new in specs]
        engine.run()
        chaos.reset()
        scrape = _scrape() if on else None
    sched = {k: v - before[k] for k, v in engine.scheduler.stats.items()}
    # the engine's counters run over its lifetime: this run's tokens/s
    # from this run's requests
    summary = dict(engine.metrics_summary())
    summary["tokens_per_sec"] = sum(len(st.generated) for st in states) \
        / summary["elapsed_s"]
    return (states, summary, reg, sched, scrape,
            list(engine._lat["decode_step"]))


def _registry_write_us() -> str:
    """Microseconds a registry counter write and histogram observe take
    on this host, each the median of 5 batches of 20000."""
    import numpy as np
    from paddle_tpu_torch.monitor import MetricsRegistry
    reg = MetricsRegistry()
    out = []
    for name, fn in (
            ("counter", lambda: reg.counter(
                "serve_tokens_generated_total", "tokens").inc()),
            ("histogram", lambda: reg.histogram(
                "serve_ttft_seconds", "ttft").observe(0.01, exemplar=None))):
        batches = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(20000):
                fn()
            batches.append((time.perf_counter() - t) / 20000 * 1e6)
        out.append(f"{name} {np.median(batches):.3f} us")
    return ", ".join(out)


def _scrape() -> dict:
    """The admin plane's endpoints, each as (status, body, ms)."""
    from paddle_tpu_torch.monitor import server
    srv = server.get_server()
    _require(srv is not None, "monitor serve: no admin server")
    out = {}
    for path in ("/metrics", "/healthz", "/readyz", "/statusz",
                 "/debug/flight"):
        t = time.perf_counter()
        code, body = _http_get(f"http://127.0.0.1:{srv.port}{path}")
        out[path] = (code, body, (time.perf_counter() - t) * 1e3)
    return out


def _http_get(url: str):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _monitor_serve(tmp: str) -> dict:
    """(a) Phase 3's engine and requests run off and on in
    ``MONITOR_SERVE_ORDER``. The on
    runs must fail the poisoned request alone, agree with the off run's
    tokens (near-ties under ``TIE_GAP``), count their requests as the
    scheduler does, and leave a lint-clean scrape, a kept chaos trace, a
    Perfetto file and a ``request_failed`` flight event."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.monitor import (flight_recorder, lint_exposition,
                                          server, trace)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    cfg = gpt2_medium()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    off = ServingEngine(model, ServingConfig(**SERVE_CFG), device="cuda")
    with _flags(MONITOR_SERVE_FLAGS):
        on = ServingEngine(model, ServingConfig(slo_availability=0.99,
                                                **SERVE_CFG),
                           device="cuda")
    off.warmup()
    on.warmup()
    specs = _slice_specs(cfg.vocab_size)
    # one untimed run through each engine first: a first run pays for
    # cuBLAS's and the allocator's first-use work
    for eng, flags in ((off, {}), (on, MONITOR_SERVE_FLAGS)):
        with _flags(flags):
            _monitor_serve_run(eng, specs, False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    runs = {"off": [], "on": []}
    for tag in MONITOR_SERVE_ORDER:
        runs[tag].append(_monitor_serve_run(
            on if tag == "on" else off, specs, tag == "on"))
    torch.cuda.synchronize()
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    L = cfg.num_layers
    _log(f"monitor serve: launches over the {len(MONITOR_SERVE_ORDER)} "
         f"runs {launches}")
    _require(launches["flash_attention_fwd"] > 0
             and launches["paged_decode_attention"] > 0
             and launches["paged_decode_attention"] % L == 0,
             "monitor serve: rows 1 (f32) and 9 were not launched")
    ref_states = runs["off"][0][0]
    _require(all(st.outcome == "completed" for r in runs["off"]
                 for st in r[0]), "monitor serve: an off request failed")
    for i, (states, summary, reg, sched, scrape, _) in enumerate(
            runs["on"]):
        failed = [st for st in states if st.outcome == "failed"]
        _require(len(failed) == 1 and failed[0] is states[2]
                 and "non-finite logits" in (failed[0].failure or ""),
                 "monitor serve: failures " + str(
                     [(s.request.request_id, s.failure) for s in failed]))
        done = [st for st in states if st.outcome == "completed"]
        _require(len(done) == NUM_REQUESTS - 1,
                 f"monitor serve: {len(done)} completed")
        same = sum(a.generated == b.generated
                   for a, b in zip(ref_states, states)
                   if b.outcome == "completed")
        _log(f"monitor serve: on run {i + 1}: {same} of {len(done)} "
             "completed requests give the off run's tokens exactly")
        if same < len(done):
            _teacher_forced("monitor serve", model, done, TIE_GAP)
        events = {lab["event"]: int(v) for lab, v in
                  reg.get("serve_requests_total").samples()}
        _require(events == {k: sched[k] for k in events} == {
            "submitted": NUM_REQUESTS, "completed": NUM_REQUESTS - 1,
            "failed": 1},
            f"monitor serve: serve_requests_total {events}, scheduler "
            f"{sched}")
        first = sum(1 for st in states if st.first_token_t is not None)
        ttft = reg.get("serve_ttft_seconds").count()
        _require(ttft == first == NUM_REQUESTS - 1,
                 f"monitor serve: serve_ttft_seconds count {ttft}, "
                 f"{first} requests had a first token")
        code, text, scrape_ms = scrape["/metrics"]
        lint = lint_exposition(text)
        _require(code == 200 and not lint and 'serve_requests_total{event='
                 '"failed"} 1' in text,
                 f"monitor serve: /metrics {code}, lint {lint[:3]}")
        codes = {p: v[0] for p, v in scrape.items()}
        _require(all(c == 200 for c in codes.values()),
                 f"monitor serve: admin plane {codes}")
        _log(f"monitor serve: on run {i + 1}: /metrics {len(text)} bytes in "
             f"{scrape_ms:.2f} ms (scraped after the run's timed window), "
             f"exposition lint clean; " + ", ".join(
                 f"{p} {v[0]} in {v[2]:.2f} ms" for p, v in scrape.items()))
    _log(f"monitor serve: serve_requests_total {events}, as the "
         f"scheduler's counts of the run {sched}")
    kept = [d for d in trace.get_tracer().snapshot()
            if d.get("anomaly") == "chaos"]
    n_on = MONITOR_SERVE_ORDER.count("on")
    _require(len(kept) == n_on and all(
        d["spans"][0]["attrs"].get("outcome") == "failed" for d in kept),
        f"monitor serve: {len(kept)} chaos traces kept")
    path = trace.export_perfetto(os.path.join(tmp, "serve_trace.json"))
    n_retained = len(trace.get_tracer().retained())
    events_fr = [e["event"] for e in
                 flight_recorder.get_flight_recorder().events]
    _require(events_fr.count("request_failed") == n_on,
             f"monitor serve: flight events {events_fr}")
    _log(f"monitor serve: {n_retained} traces retained, the {n_on} "
         f"poisoned requests' with anomaly 'chaos'; Perfetto file "
         f"{os.path.getsize(path)} bytes; flight ring events {events_fr}")
    for tag in ("off", "on"):
        s = [r[1] for r in runs[tag]]
        pooled = np.concatenate([r[5] for r in runs[tag]])
        tps = [x["tokens_per_sec"] for x in s]
        _log(f"monitor serve: {tag}, runs in order: tokens/s "
             + ", ".join(f"{x:.2f}" for x in tps)
             + f" (median {np.median(tps):.2f}); decode p50 " + ", ".join(
                 _ms(x["decode_step_p50_s"]) for x in s)
             + "; decode p99 " + ", ".join(
                 _ms(x["decode_step_p99_s"]) for x in s)
             + f"; over all {len(pooled)} decode steps p50 "
             f"{_ms(float(np.percentile(pooled, 50)))}, p99 "
             f"{_ms(float(np.percentile(pooled, 99)))}")
    busy_off = _profile_serve("monitor serve off", off, specs)
    with _flags(MONITOR_SERVE_FLAGS):
        busy_on = _profile_serve("monitor serve on", on, specs)
    _log(f"monitor serve: device busy share off {100 * busy_off:.2f}%, "
         f"on {100 * busy_on:.2f}% (one more run of each, no poison)")
    _log("monitor serve: host cost of one registry write "
         + _registry_write_us() + " (lookup by name plus the locked "
         "update; the engine does a few a token and a few a dispatch)")
    on.shutdown()
    off.shutdown()
    server.stop_server()
    del on, off, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# each feature alone, then all together, for the step-time table
MONITOR_FEATURES = (
    ("none", {}, False),
    ("monitor", {"monitor": True}, False),
    ("trace", {"trace": True, "trace_sample": 1.0}, False),
    ("flight_recorder", {"flight_recorder": True}, False),
    ("train_goodput", {"train_goodput": True}, False),
    ("train_health_every=2", {"train_health_every": 2}, False),
    ("check_numerics", {}, True),
    ("all", {"monitor": True, "trace": True, "trace_sample": 1.0,
             "flight_recorder": True, "train_goodput": True,
             "train_health_every": 2}, True),
    ("none", {}, False),
)


def _feature_step_ms(step, batch, flags: dict, check: bool) -> float:
    """Mean step time over ``FEATURE_STEPS`` steps queued back to back
    (one sync at the end, so a feature's own syncs show), after one
    warm step."""
    import torch
    step._check_numerics = "warn" if check else False
    with _flags(flags):
        step(*batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FEATURE_STEPS):
            loss = step(*batch)
        float(loss)
        ms = (time.perf_counter() - t0) / FEATURE_STEPS * 1e3
    step._check_numerics = False
    return ms


def _monitor_features() -> None:
    """Phase 10's BERT-base step on a resident batch with each monitor
    feature alone and all together, against none, in one run: the
    table in ``FEATURE_PASSES`` passes, alternately forward and in
    reverse order."""
    import numpy as np
    import torch
    from paddle_tpu_torch.monitor import goodput, scoped_registry
    _, _, step, batch = _encoder_setup("bert")
    with _flags({"monitor": True}), scoped_registry():
        step(*batch)                    # the monitored step's attribution
    torch.cuda.synchronize()
    rows = {}
    order = list(MONITOR_FEATURES)
    for p in range(FEATURE_PASSES):
        for name, flags, check in (order if p % 2 == 0 else order[::-1]):
            goodput.reset()
            with scoped_registry():
                rows.setdefault(name, []).append(
                    _feature_step_ms(step, batch, flags, check))
    goodput.reset()
    none = float(np.median(rows["none"]))
    _log(f"monitor train: step ms with each feature ({FEATURE_STEPS} steps "
         f"queued back to back, one sync; {FEATURE_PASSES} pass(es), "
         "alternately forward and reverse): " + "; ".join(
             f"{n} " + "/".join(f"{x:.2f}" for x in v)
             + f" (median {np.median(v):.2f}, "
             f"{100 * (np.median(v) / none - 1):+.1f}% on none)"
             for n, v in rows.items()))
    del step
    gc.collect()
    torch.cuda.empty_cache()


def _state_snapshot(step):
    """Clones of every parameter and optimizer slot, and the step count."""
    return ([p.detach().clone() for p in step.layer.parameters()],
            [s.clone() for slots in step.optimizer._accumulators.values()
             for s in slots], step.step_count)


def _same_state(a, b) -> bool:
    import torch
    return a[2] == b[2] and len(a[0]) == len(b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


def _monitor_train(tmp: str) -> dict:
    """(b) Eight DataLoader-fed BERT-base O1 steps with the monitor on,
    the goodput ledger, layer health every 2 steps, the watchdog in warn
    mode with a budget of one skip and ``grad.nonfinite@4``: the fourth
    step is skipped with the state bit-identical, the ledger sums to the
    run's wall time, every layer's gradient norm is finite, no leak over
    steps 5-8, a profiler window over steps 6-7 names the hand-written
    kernels, and the first step's cost count beside the analytic
    FLOPs."""
    import warnings
    import numpy as np
    import torch
    from paddle_tpu_torch import io
    from paddle_tpu_torch import profiler as prof
    from paddle_tpu_torch.monitor import (LeakMonitor, goodput,
                                          live_buffer_census, memory_summary,
                                          scoped_registry)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing import chaos
    records = _Records(range(MONITOR_TRAIN_STEPS), 30528)
    loader = io.DataLoader(records, batch_size=BERT_B, num_workers=2,
                           prefetch_factor=2, places="cuda")
    flags = {"monitor": True, "train_goodput": True,
             "train_health_every": 2}
    trace_dir = os.path.join(tmp, "profile")
    window = prof.Profiler(scheduler=(5, 7),
                           on_trace_ready=prof.export_chrome_tracing(
                               trace_dir))
    leak = LeakMonitor(window=3)
    torch.cuda.synchronize()
    with _flags(flags), scoped_registry() as reg, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        goodput.reset()
        t_start = time.perf_counter()
        goodput.active_ledger()
        cfg, _, step, _ = _encoder_setup("bert")
        step._check_numerics = "warn"
        step.skip_nonfinite_budget = 1
        chaos.configure("grad.nonfinite@4")
        t_build = time.perf_counter() - t_start
        kernels.reset_launch_counts()
        t = time.perf_counter()
        it = iter(loader)
        t_fill = time.perf_counter() - t
        window.start()
        losses, skipped, leaked = [], None, False
        for i in range(1, MONITOR_TRAIN_STEPS + 1):
            batch = next(it)
            before = _state_snapshot(step) if i == 4 else None
            losses.append(float(step(*batch)))
            if before is not None:
                skipped = _same_state(before, _state_snapshot(step))
                del before
            if i >= 5:
                leaked = leak.observe(step=i) or leaked
            window.step()
        window.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {k["name"]: k["launches"] for k in kernels.kernels()}
        chaos.reset()
        snap = goodput.get_ledger().snapshot()
        stats = step.stats()
        skips = reg.get("nonfinite_skips_total").value()
        norms = [v for _, v in reg.get("train_layer_grad_norm").samples()]
        census = live_buffer_census(step)
        summary = memory_summary(step)
    _log("monitor train: losses " + " ".join(f"{x:.4f}" for x in losses)
         + f"; step_count {step.step_count}")
    _require(np.isnan(losses[3]) and all(
        math.isfinite(x) for j, x in enumerate(losses) if j != 3),
        f"monitor train: losses {losses}")
    _require(skipped is True, "monitor train: the skipped step changed the "
             "parameters, the slots or the step count")
    _require(step.step_count == MONITOR_TRAIN_STEPS - 1 and skips == 1
             and stats["nonfinite_skips"] == 1,
             f"monitor train: step_count {step.step_count}, "
             f"nonfinite_skips_total {skips}")
    _require(any("update skipped" in str(w.message) for w in caught),
             "monitor train: the skip was not warned")
    total = sum(snap["buckets"].values())
    _require(abs(total - wall) <= 0.01 * wall,
             f"monitor train: goodput buckets {total:.3f} s against the "
             f"run's {wall:.3f} s")
    _require(snap["buckets"]["data_wait"] > 0, "monitor train: no data_wait")
    _log(f"monitor train: goodput {snap['goodput_pct']:.2f}% of "
         f"{snap['elapsed_s']:.3f} s (run {wall:.3f} s); buckets " + ", ".join(
             f"{b} {v:.4f}" for b, v in snap["buckets"].items())
         + f"; host_other holds the model's build ({t_build:.3f} s) and "
         f"the loader's first fill in iter() ({t_fill:.3f} s, two spawned "
         "workers), which the JAX DataLoader too leaves outside data_wait")
    _require(norms and all(math.isfinite(x) for x in norms),
             f"monitor train: layer grad norms {norms}")
    _log(f"monitor train: {len(norms)} train_layer_grad_norm gauges, all "
         f"finite ({min(norms):.4g} to {max(norms):.4g})")
    _require(not leaked and leak.suspected == 0,
             "monitor train: LeakMonitor saw growth over steps 5-8")
    _log(f"monitor train: LeakMonitor over steps 5-8: no growth "
         f"({leak._history})")
    _log("monitor train: live_buffer_census " + json.dumps(census))
    for ln in summary.splitlines():
        _log(f"monitor train: {ln}")
    want = _encoder_launches(cfg, MONITOR_TRAIN_STEPS)
    _log(f"monitor train: launches over {MONITOR_TRAIN_STEPS} calls "
         f"{launches}")
    _require(launches == want, f"monitor train: launches {launches} != "
             f"{want} (the skipped step launches what a step does)")
    files = sorted(os.listdir(trace_dir))
    _require(window.windows == 1 and files,
             f"monitor train: profiler windows {window.windows}, {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sorted(n for n in names if k in n)[:1]
             for k in MONITOR_TRAIN_KERNELS}
    _log(f"monitor train: profiler window over steps 6-7 ({len(names)} "
         f"event names) names " + "; ".join(
             f"{k}: {v[0][:70] if v else None}" for k, v in found.items()))
    _require(all(found.values()), f"monitor train: kernels missing from "
             f"the chrome trace: {[k for k, v in found.items() if not v]}")
    prog = stats["programs"]["step"]
    analytic = bert_flops_per_token(cfg) * BERT_B * BERT_S
    _log(f"monitor train: CostModel count of the first step: "
         f"{prog['flops']:.4e} FLOPs ({prog['torch_flops']:.4e} in torch "
         f"operators, {prog['kernel_flops']:.4e} reported by the kernel "
         f"wrappers: " + ", ".join(
             f"{k} x{v['calls']} {v['flops']:.3e}"
             for k, v in step._programs["step"]["kernels"].items())
         + f"), {prog['bytes_accessed']:.4e} bytes, peak "
         f"{(prog['peak_bytes'] or 0) / 2**30:.3f} GiB; analytic "
         f"{analytic:.4e} FLOPs (bench.py's count, "
         f"{bert_flops_per_token(cfg):.4e} a token), counted/analytic "
         f"{prog['flops'] / analytic:.4f}; MFU gauge "
         f"{stats['programs']['step']['mfu']}")
    _require(prog["kernel_flops"] > 0 and prog["flops"] > 0,
             "monitor train: the cost count saw no kernel")
    del step, loader, it
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_monitor():
    """The monitor plane on the f32 serving path and the DataLoader-fed
    BERT-base training path. Returns the launches of each."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        serve = _monitor_serve(tmp)
        _monitor_features()
        train = _monitor_train(tmp)
    return serve, train


# -- phase 19: the checkpoint and the resilience plane -------------------------
# part (b): phase 3's engine under the priority policy with a queue of 16
# and the overload detector at 0.25 s; 48 requests of bench-like lengths,
# priorities 0-2 and deadlines 0.5-4 s, submitted at once
RES_SPEC = dict(num_requests=48, rate_rps=1e6, prompt_len_range=PROMPT_RANGE,
                max_new_range=NEW_TOKENS_RANGE, vocab_size=50304, seed=19,
                deadline_range=(0.5, 4.0), priority_choices=(0, 1, 2))
RES_QUEUE, RES_OVERLOAD_S = 16, 0.25
# part (c): steps before the drain latch triggers, and the grace budget
RES_DRAIN_AFTER, RES_DRAIN_BUDGET_S = 6, 0.25
# part (d): the watchdog's budget and the decode dispatch that hangs
RES_WATCHDOG_S, RES_HANG_AT = 2.0, 5
# the armed watchdog of part (a), and the order of its timed runs
RES_ARMED_S = 5.0
RES_ARMED_ORDER = ("off", "armed", "armed", "off") * 2
# part (e): the LoRA engine and the BERT-base steps
RES_ADAPTERS, RES_RANK, RES_LORA_REQUESTS = 4, 8, 8
RES_TRAIN_STEPS = 3
# the resilience plane's registry series: none may appear with it off
RES_SERIES = ("serve_overload", "serve_deadline", "serve_watchdog", "slo_")


def _res_counted(acc: dict, fn):
    """``fn()`` with the launch counts set to 0 before and added to
    ``acc`` after; returns (``fn()``'s result, this run's counts)."""
    import torch
    from paddle_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    run = {k["name"]: k["launches"] for k in kernels.kernels()}
    for name, n in run.items():
        acc[name] = acc.get(name, 0) + n
    return out, run


def _res_serve(engine, specs, **kw):
    """Submit phase 3's requests and run them; this run's states and
    decode step times."""
    from paddle_tpu_torch.serving import Request, SamplingParams
    n0 = len(engine._lat["decode_step"])
    states = [engine.submit(Request(p, max_new_tokens=new,
                                    sampling=SamplingParams(), **kw))
              for p, new in specs]
    engine.run()
    return states, engine._lat["decode_step"][n0:]


def _res_guard_us(engine, n: int = 2000) -> tuple:
    """Host microseconds of one ``_guarded_dispatch`` of an empty job,
    off and armed (the worker handoff and the event wait), each the
    median of 5 batches of ``n``."""
    import numpy as np
    from paddle_tpu_torch.core import flag_scope
    out = []
    for armed in (0.0, RES_ARMED_S):
        batches = []
        with flag_scope("serve_watchdog_s", armed):
            for _ in range(5):
                t = time.perf_counter()
                for _ in range(n):
                    engine._guarded_dispatch("decode", lambda: None)
                batches.append((time.perf_counter() - t) / n * 1e6)
        out.append(float(np.median(batches)))
    return tuple(out)


def _res_off(model, specs, serve: tuple, acc: dict) -> list:
    """(a) Phase 3's requests with every knob off: phase 3's launches
    exactly, phase 3's tokens, no resilience series and only submitted
    and completed events; then off, armed (``serve_watchdog_s`` 5),
    armed, off: the same tokens and launches, decode p50 off against
    armed, and the guarded dispatch's own host cost."""
    import numpy as np
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.monitor import scoped_registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    serve_launches, f32 = serve
    eng = ServingEngine(model, ServingConfig(**SERVE_CFG), device="cuda")
    eng.warmup()
    with scoped_registry() as reg:
        (states, _), run = _res_counted(acc, lambda: _res_serve(eng, specs))
        names = [n for n in reg.names() if n.startswith(RES_SERIES)]
        events = {lab["event"]: int(v) for lab, v in
                  reg.get("serve_requests_total").samples()}
    tokens = [st.generated for st in states]
    _require(run == serve_launches,
             f"resilience off: launches {run} != phase 3's {serve_launches}")
    _require(tokens == f32["tokens"], "resilience off: tokens differ from "
             "phase 3's")
    _require(not names and events == {"submitted": NUM_REQUESTS,
                                       "completed": NUM_REQUESTS},
             f"resilience off: series {names}, events {events}")
    _require(eng._watchdog_worker is None, "resilience off: a watchdog "
             "worker started")
    _log(f"resilience off: launches equal phase 3's {run}; tokens equal "
         "phase 3's; no resilience series, events {submitted, completed}")
    decode = {"off": [], "armed": []}
    for tag in RES_ARMED_ORDER:
        with flag_scope("serve_watchdog_s",
                        RES_ARMED_S if tag == "armed" else 0.0):
            (sts, steps), run2 = _res_counted(
                acc, lambda: _res_serve(eng, specs))
        _require([st.generated for st in sts] == tokens,
                 f"resilience {tag}: tokens differ from the first off run")
        _require(run2 == run, f"resilience {tag}: launches {run2} != {run}")
        decode[tag].append(steps)
    _require(len(eng._watchdog_threads) == 1, "resilience armed: "
             f"{len(eng._watchdog_threads)} dispatcher threads")
    off_us, armed_us = _res_guard_us(eng)
    p50 = {k: float(np.percentile(np.concatenate(v), 50)) * 1e3
           for k, v in decode.items()}
    n = RES_ARMED_ORDER.count("off")
    _log(f"resilience armed: the same tokens and launches as off over {n} "
         f"runs each ({', '.join(RES_ARMED_ORDER)}), one dispatcher "
         f"thread; decode p50 over each side's {len(decode['off'][0]) * n} "
         "steps "
         f"off {p50['off']:.3f} ms, armed {p50['armed']:.3f} ms "
         f"({p50['armed'] - p50['off']:+.3f} ms); runs "
         + "; ".join(k + " " + ", ".join(
             f"{float(np.percentile(x, 50)) * 1e3:.3f}" for x in decode[k])
             for k in ("off", "armed"))
         + f" ms; one guarded dispatch of an empty job costs "
         f"{off_us:.2f} us off, {armed_us:.2f} us armed (worker handoff "
         f"+ event wait: {armed_us - off_us:.2f} us a dispatch)")
    eng.shutdown()
    return tokens


def _res_overload(model, acc: dict) -> None:
    """(b) 48 requests with priorities and deadlines at once into a
    queue of 16 under the priority policy, a queued and an in-flight
    cancel, the overload detector at 0.25 s and a probe submit once it
    trips: every request one terminal outcome, offered = submitted +
    rejected, completed requests teacher-forced."""
    from paddle_tpu_torch.monitor import scoped_registry
    from paddle_tpu_torch.serving import (TERMINAL_OUTCOMES, LoadSpec,
                                          Request, ServerOverloaded,
                                          ServingConfig, ServingEngine,
                                          build_requests)
    eng = ServingEngine(model, ServingConfig(
        **SERVE_CFG, queue_policy="priority", max_queue=RES_QUEUE,
        overload_threshold_s=RES_OVERLOAD_S), device="cuda")
    reqs = [r for _, r in build_requests(LoadSpec(**RES_SPEC))]
    states, refused, probes, ready = [], {}, [], set()

    def run():
        for r in reqs:
            try:
                states.append(eng.submit(r))
            except ServerOverloaded as e:
                refused[e.reason] = refused.get(e.reason, 0) + 1
        cancels = []
        steps = 0
        while eng.scheduler.has_work:
            eng.step()
            steps += 1
            if steps == 1:
                queued = eng.scheduler.waiting[-1]
                flight = eng.scheduler.active()[0][1]
                for st in (queued, flight):
                    _require(eng.cancel(st.request.request_id),
                             "resilience overload: cancel missed")
                    cancels.append(st)
            r = eng._readiness()
            ready.add(r["state"] if r else "ready")
            if eng._overload.overloaded and not probes:
                probe = Request(reqs[0].prompt, max_new_tokens=16)
                try:
                    states.append(eng.submit(probe))
                except ServerOverloaded as e:
                    probes.append(e.reason)
                    refused[e.reason] = refused.get(e.reason, 0) + 1
        return cancels, steps

    with scoped_registry() as reg:
        t0 = time.perf_counter()
        (cancels, steps), _ = _res_counted(acc, run)
        wall = time.perf_counter() - t0
        events = {lab["event"]: int(v) for lab, v in
                  reg.get("serve_requests_total").samples()}
        transitions = reg.get("serve_overload_transitions_total")
        n_enter = transitions.value(state="enter") if transitions else 0
    stats = eng.scheduler.stats
    offered = len(reqs) + len(probes)
    rejected = sum(refused.values())
    outcomes = {o: sum(st.outcome == o for st in states)
                for o in TERMINAL_OUTCOMES}
    _require(all(st.outcome in TERMINAL_OUTCOMES for st in states),
             "resilience overload: a request without a terminal outcome")
    _require(offered == stats["submitted"] + rejected == len(states)
             + rejected, f"resilience overload: offered {offered}, "
             f"submitted {stats['submitted']}, rejected {rejected}")
    _require(outcomes == {o: stats[o] for o in TERMINAL_OUTCOMES}
             and sum(outcomes.values()) == stats["submitted"],
             f"resilience overload: outcomes {outcomes}, stats {stats}")
    _require(events.get("rejected", 0) == rejected and sum(
        events.get(o, 0) for o in TERMINAL_OUTCOMES) == events["submitted"],
        f"resilience overload: events {events}")
    _require([st.outcome for st in cancels] == ["cancelled", "cancelled"],
             "resilience overload: cancels ended "
             f"{[st.outcome for st in cancels]}")
    _require(probes == ["overload"] and n_enter >= 1
             and "shedding" in ready,
             f"resilience overload: probes {probes}, transitions "
             f"{n_enter}, readiness {sorted(ready)}")
    _require(eng.cache.allocator.pages_in_use == 0,
             "resilience overload: pages leaked")
    done = [st for st in states if st.outcome == "completed"]
    _require(done, "resilience overload: nothing completed")
    _teacher_forced("resilience overload", model, done, TIE_GAP)
    summary = dict(eng.metrics_summary(), num_requests=offered,
                   requests_rejected=rejected)
    avail, shed = _serve_resilience_metrics(summary)
    _log(f"resilience overload: {offered} offered ({len(reqs)} at once + "
         f"{len(probes)} probe), {stats['submitted']} submitted, "
         f"{rejected} rejected {refused}; outcomes {outcomes} "
         f"({stats['expired_queued']} expired queued); {steps} steps in "
         f"{wall:.2f} s; overload entered {int(n_enter)} time(s), readiness "
         f"states seen {sorted(ready)}; availability {avail:.2f}%, shed "
         f"rate {shed:.2f}% (bench.py's serve_resilience_metrics)")
    eng.shutdown()


def _serve_resilience_metrics(summary: dict) -> tuple:
    """bench.py's ``serve_resilience_metrics``: availability = completed
    / offered; shed rate = (rejected + shed + queued expiries) /
    offered, in percent."""
    offered = max(int(summary.get("num_requests") or 0), 1)
    completed = int(summary.get("requests_completed") or 0)
    shed = (int(summary.get("requests_rejected") or 0)
            + int(summary.get("requests_shed") or 0)
            + int(summary.get("requests_expired_queued") or 0))
    return 100.0 * completed / offered, 100.0 * shed / offered


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _same_streams(tag, model, got, want, prompts) -> int:
    """Greedy streams ``got`` against ``want`` (both generated tokens
    after ``prompts``): equal, or diverging at a near-tie (the two
    tokens within ``TIE_GAP`` of each other in a no-cache forward of the
    shared prefix). Returns the count of equal streams."""
    import numpy as np
    import torch
    same = 0
    for g, w, p in zip(got, want, prompts):
        if g == w:
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        seq = np.concatenate([p, np.asarray(w[:i], np.int32)])
        with torch.no_grad():
            lg = model(torch.from_numpy(seq[None].astype(np.int64)).cuda()
                       )[0, -1].float()
        gap = abs(float(lg[g[i]] - lg[w[i]]))
        _require(gap < TIE_GAP, f"{tag}: streams diverge at token {i} by "
                 f"a logit gap of {gap} >= {TIE_GAP}")
    return same


def _res_drain(model, specs, tokens, tmp: str, acc: dict) -> None:
    """(c) ``enable_drain``, the latch triggered after six steps, the
    engine drained; a successor built from the same weights resumes the
    snapshot, each greedy stream (prompt + before + after) the
    uninterrupted run's; then a drain of the successor torn by
    ``ckpt.write.torn`` leaves the first snapshot the one that loads."""
    import numpy as np
    import torch
    import paddle_tpu_torch.serving.engine as engine_mod
    from paddle_tpu_torch.serving import (EngineDrained, Request,
                                          SamplingParams, ServingConfig,
                                          ServingEngine, load_drain_snapshot,
                                          requests_from_snapshot)
    from paddle_tpu_torch.testing import chaos
    root = os.path.join(tmp, "drain")
    commits = []
    real_save = engine_mod.save_drain_snapshot

    def timed_save(*a, **kw):
        t = time.perf_counter()
        path = real_save(*a, **kw)
        commits.append((path, (time.perf_counter() - t) * 1e3))
        return path
    engine_mod.save_drain_snapshot = timed_save
    torch.cuda.reset_peak_memory_stats()
    try:
        eng = ServingEngine(model, ServingConfig(**SERVE_CFG),
                            device="cuda")
        latch = eng.enable_drain(root, budget_s=RES_DRAIN_BUDGET_S)

        def first():
            sts = [eng.submit(Request(p, max_new_tokens=new,
                                      sampling=SamplingParams()))
                   for p, new in specs]
            for _ in range(RES_DRAIN_AFTER):
                eng.step()
            latch.trigger()
            t = time.perf_counter()
            try:
                eng.run()
            except EngineDrained as e:
                return sts, e.report, time.perf_counter() - t
            raise RuntimeError("resilience drain: no EngineDrained")
        (sts, report, drain_s), _ = _res_counted(acc, first)
        _require(eng._readiness()["state"] == "drained",
                 f"resilience drain: readiness {eng._readiness()}")
        _require(all(st.outcome in ("completed", "drained") for st in sts)
                 and sum(st.outcome == "drained" for st in sts)
                 == report.snapshotted > 0,
                 f"resilience drain: report {report}")
        path, snap = load_drain_snapshot(root)
        _require(path == report.path and len(snap) == report.snapshotted,
                 f"resilience drain: loaded {path}")
        eng.shutdown()
        del eng
        gc.collect()
        succ = ServingEngine(model, ServingConfig(**SERVE_CFG),
                             device="cuda")
        by_id = {st.request.request_id: i for i, st in enumerate(sts)}

        def resume():
            states = [succ.submit(r) for r in requests_from_snapshot(snap)]
            succ.run()
            return states
        resumed, _ = _res_counted(acc, resume)
        _require(all(st.outcome == "completed" for st in resumed),
                 "resilience drain: a resumed request did not complete")
        got, want, prompts = [], [], []
        for d, st in zip(snap, resumed):
            i = by_id[d["request_id"]]
            got.append(list(d["generated"]) + st.generated)
            want.append(tokens[i])
            prompts.append(np.asarray(d["prompt"], np.int32))
        for st in sts:
            if st.outcome == "completed":
                _require(st.generated == tokens[by_id[st.request.request_id]],
                         "resilience drain: a request completed in the "
                         "grace budget differs from the uninterrupted run")
        same = _same_streams("resilience drain", model, got, want, prompts)
        ttft = succ.metrics_summary()
        # the torn second drain: the first snapshot stays the valid one
        extra = [succ.submit(Request(p, max_new_tokens=new))
                 for p, new in specs[:2]]
        with chaos.chaos_scope("ckpt.write.torn@1"):
            torn = succ.drain(snapshot_dir=root, budget_s=0.0)
        path2, snap2 = load_drain_snapshot(root)
        _require(torn.path.endswith("drain_2") and path2 == report.path
                 and snap2 == snap and all(st.outcome == "drained"
                                           for st in extra),
                 f"resilience drain: torn {torn.path}, loaded {path2}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        succ.shutdown()
    finally:
        engine_mod.save_drain_snapshot = real_save
    (p1, ms1), (p2, ms2) = commits
    _log(f"resilience drain: after {RES_DRAIN_AFTER} steps the latch "
         f"drained in {drain_s:.3f} s (grace budget {RES_DRAIN_BUDGET_S} "
         f"s): {report.completed} completed, {report.snapshotted} "
         f"snapshotted; snapshot commit {ms1:.3f} ms, {_dir_bytes(p1)} "
         f"bytes; the successor resumed {len(resumed)} requests, "
         f"{same} of {len(got)} streams equal to the uninterrupted run's "
         f"exactly" + ("" if same == len(got) else
                       f" (the rest diverge at a near-tie under "
                       f"{TIE_GAP:g})") + ", "
         f"TTFT p50 {_ms(ttft['ttft_p50_s'])} p99 "
         f"{_ms(ttft['ttft_p99_s'])}; torn drain_2 commit {ms2:.3f} ms, "
         f"{_dir_bytes(p2)} bytes on disk, skipped: drain_1 loads; peak "
         f"device memory {peak:.3f} GiB (the first engine shut down "
         "before the successor was built)")


def _res_watchdog(model, specs, tokens, acc: dict) -> None:
    """(d) ``serve_watchdog_s`` 2 and ``serve.decode.hang`` at the fifth
    decode dispatch: ``DecodeWatchdogError(retry_safe=True)``, /readyz
    503 ``watchdog-tripped``, and the retried run's tokens are the
    untripped run's."""
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.monitor import server
    from paddle_tpu_torch.serving import (DecodeWatchdogError, Request,
                                          SamplingParams, ServingConfig,
                                          ServingEngine)
    from paddle_tpu_torch.testing import chaos
    with flag_scope("monitor_port", -1):
        eng = ServingEngine(model, ServingConfig(**SERVE_CFG),
                            device="cuda")
    url = f"http://127.0.0.1:{server.get_server().port}/readyz"

    def run():
        sts = [eng.submit(Request(p, max_new_tokens=new,
                                  sampling=SamplingParams()))
               for p, new in specs]
        with flag_scope("serve_watchdog_s", RES_WATCHDOG_S):
            chaos.configure(f"serve.decode.hang@{RES_HANG_AT}")
            trip = None
            while eng.scheduler.has_work:
                t = time.perf_counter()
                try:
                    eng.step()
                except DecodeWatchdogError as e:
                    trip = (e, time.perf_counter() - t,
                            _http_get(url), eng._readiness())
            chaos.reset()
        return sts, trip
    try:
        (sts, trip), _ = _res_counted(acc, run)
    finally:
        chaos.reset()
        eng.shutdown()
        server.stop_server()
    _require(trip is not None, "resilience watchdog: no trip")
    err, trip_s, (code, body), ready = trip
    _require(err.kind == "decode" and err.retry_safe
             and err.timeout_s == RES_WATCHDOG_S,
             f"resilience watchdog: {err!r}")
    _require(code == 503 and "watchdog-tripped" in body
             and ready["state"] == "watchdog-tripped",
             f"resilience watchdog: /readyz {code} {body[:200]}")
    _require([st.generated for st in sts] == tokens,
             "resilience watchdog: the retried run's tokens differ from "
             "the untripped run's")
    _log(f"resilience watchdog: decode dispatch #{err.dispatch_seq} hung "
         f"(serve.decode.hang@{RES_HANG_AT}); DecodeWatchdogError after "
         f"{trip_s:.3f} s (budget {RES_WATCHDOG_S} s), retry_safe "
         f"{err.retry_safe}, {err.active_slots} active slots; /readyz "
         f"{code} watchdog-tripped; the retried step and the rest of the "
         f"run gave the untripped run's {sum(map(len, tokens))} tokens "
         "exactly")


def _res_lora(model, tmp: str, acc: dict) -> None:
    """(e) Four rank-8 adapters through ``save_adapter_checkpoint`` and
    ``load_adapter(path=)``: the pools and eight requests' tokens
    bit-equal to the engine loaded with ``weights=``; bgmv once per
    layer per dispatch."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.serving import (Request, SamplingParams,
                                          ServingConfig, ServingEngine,
                                          save_adapter_checkpoint)
    L, E = model.cfg.num_layers, model.cfg.hidden_size
    rng = np.random.default_rng(41)
    weights = {f"a{i}": (rng.standard_normal((L, RES_RANK, E)).astype(
        np.float32) * 1e-2, rng.standard_normal((L, RES_RANK, 3 * E)).astype(
        np.float32) * 1e-2) for i in range(RES_ADAPTERS)}
    paths, save_ms, nbytes = {}, [], 0
    for name, (a, b) in weights.items():
        paths[name] = os.path.join(tmp, f"adapter_{name}")
        t = time.perf_counter()
        save_adapter_checkpoint(paths[name], a, b)
        save_ms.append((time.perf_counter() - t) * 1e3)
        nbytes += _dir_bytes(paths[name])
        _require(ckpt.verify_checkpoint(paths[name], level="full") is None,
                 f"resilience lora: {paths[name]} does not verify")
    specs = _slice_specs(model.cfg.vocab_size)[:RES_LORA_REQUESTS]
    out = {}
    for source in ("path", "weights"):
        eng = ServingEngine(model, ServingConfig(
            **SERVE_CFG, lora_adapters=RES_ADAPTERS, lora_rank=RES_RANK),
            device="cuda")
        t = time.perf_counter()
        for name in weights:
            if source == "path":
                eng.lora.load_adapter(name, path=paths[name])
            else:
                eng.lora.load_adapter(name, weights=weights[name])
        load_ms = (time.perf_counter() - t) * 1e3
        names = list(weights)

        def serve():
            sts = [eng.submit(Request(p, max_new_tokens=n,
                                      sampling=SamplingParams(),
                                      adapter=names[i % len(names)]))
                   for i, (p, n) in enumerate(specs)]
            eng.run()
            return sts
        sts, run = _res_counted(acc, serve)
        s = eng.stats()
        _require(all(st.outcome == "completed" for st in sts),
                 f"resilience lora ({source}): a request failed")
        n_disp = s["prefill_dispatches"] + s["decode_dispatches"]
        _require(run["bgmv"] == L * n_disp > 0,
                 f"resilience lora ({source}): bgmv {run['bgmv']} != "
                 f"{L} x {n_disp} dispatches")
        out[source] = ([st.generated for st in sts], eng.lora.a.clone(),
                       eng.lora.b.clone(), load_ms)
        eng.shutdown()
        del eng
    (tp, ap, bp, ms_p), (tw, aw, bw, ms_w) = out["path"], out["weights"]
    _require(tp == tw and torch.equal(ap, aw) and torch.equal(bp, bw),
             "resilience lora: the path-loaded engine differs from the "
             "weights-loaded one")
    _log(f"resilience lora: {RES_ADAPTERS} rank-{RES_RANK} adapters saved "
         f"as checkpoints ({nbytes} bytes, commit "
         + ", ".join(f"{x:.2f}" for x in save_ms)
         + f" ms) and loaded by path in {ms_p:.2f} ms (by weights "
         f"{ms_w:.2f} ms): pools and {RES_LORA_REQUESTS} requests' tokens "
         "bit-equal, bgmv once per layer per dispatch")


def _res_train(tmp: str) -> dict:
    """(e) Phase 10's BERT-base O1 step: three steps, ``save_train_step``,
    three more; a fresh step (its parameters and generator scrambled)
    restored by ``load_train_step`` takes the same three. Losses and
    every parameter bit-equal; exact launches."""
    import torch
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    cfg, _, step, batch = _encoder_setup("bert")
    path = os.path.join(tmp, "step_bert")
    for _ in range(RES_TRAIN_STEPS):
        float(step(*batch))
    t = time.perf_counter()
    ckpt.save_train_step(step, path)
    save_s = time.perf_counter() - t
    ref = [float(step(*batch)) for _ in range(RES_TRAIN_STEPS)]
    ref_params = {k: v.detach().clone()
                  for k, v in step.layer.named_parameters()}
    del step
    gc.collect()
    _, _, fresh, _ = _encoder_setup("bert")
    with torch.no_grad():
        for p in fresh.layer.parameters():
            p.add_(1.0)
    fresh.generator.manual_seed(12345)
    t = time.perf_counter()
    ckpt.load_train_step(fresh, path)
    load_s = time.perf_counter() - t
    got = [float(fresh(*batch)) for _ in range(RES_TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = {k["name"]: k["launches"] for k in kernels.kernels()}
    want = _encoder_launches(cfg, 3 * RES_TRAIN_STEPS)
    _require(got == ref, f"resilience train: resumed losses {got} != {ref}")
    _require(all(torch.equal(v, ref_params[k])
                 for k, v in fresh.layer.named_parameters()),
             "resilience train: resumed parameters differ")
    _require(launches == want, f"resilience train: launches {launches} != "
             f"{want}")
    nbytes = _dir_bytes(path)
    _log(f"resilience train: BERT-base save_train_step {save_s:.3f} s, "
         f"load_train_step {load_s:.3f} s, {nbytes} bytes "
         f"({nbytes / save_s / 1e9:.3f} GB/s saved, fsync'd); the "
         f"{RES_TRAIN_STEPS} resumed steps' losses and every parameter "
         "bit-equal to the uninterrupted run's; launches exact")
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_resilience(serve: tuple):
    """The checkpoint protocol and the serving resilience plane on phase
    3's engine (parts a-d), a LoRA engine and phase 10's step (e).
    Returns the launches of the serving parts and of the train part."""
    import tempfile
    import torch
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    acc: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = gpt2_medium()
        model = GPTForPretraining(cfg, device="cuda", seed=0)
        specs = _slice_specs(cfg.vocab_size)

        def collect():
            # an engine is a reference cycle (its scheduler calls back
            # into it): free the last part's before the next one builds
            gc.collect()
            torch.cuda.empty_cache()
        collect()
        tokens = _res_off(model, specs, serve, acc)
        collect()
        _res_overload(model, acc)
        collect()
        _res_drain(model, specs, tokens, tmp, acc)
        collect()
        _res_watchdog(model, specs, tokens, acc)
        collect()
        _res_lora(model, tmp, acc)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        train = _res_train(tmp)
    _log(f"resilience: launches of the serving parts {acc}")
    return acc, train


# -- phase 20: the rest of serving -----------------------------------------------
# (a) generate over the static cache: bench-sized prompts, greedy; the
# prompts share their last token, the start token of (b)'s beam search
GEN_B, GEN_S0, GEN_NEW, GEN_LAST = 4, 64, 32, 50256
GEN_SAMPLING = dict(top_k=50, top_p=0.9)
# (b) beam search over the same model: 2 prompts, 4 beams, 16 steps; an
# end token random weights rarely pick
BEAM_B, BEAM_K, BEAM_STEPS, BEAM_END = 2, 4, 16, 50303
BEAM_SCORE_TOL = 1e-3
# (c) bench.py's serve_fleet_metrics (full): 4-slot replicas at context
# 256 with the prefix cache, the tenanted shared-prefix traffic, and its
# router config
FLEET_CFG = dict(SERVE_CFG, max_batch_slots=4, max_context_len=256)
FLEET_SPEC = dict(num_requests=48, rate_rps=24.0, prompt_len_range=(16, 64),
                  max_new_range=(8, 24), vocab_size=50304, seed=13,
                  shared_prefix_len=64, prefix_pool_size=4, prefix_zipf=1.05,
                  tenants=16)
FLEET_ROUTER = dict(seed=3, saturation_queue_depth=12)
FLEET_SIZES = (1, 4)
# (d) bench.py's serve_lifecycle_metrics (full): 2 hot-swap-armed
# replicas under MMPP traffic, three identity pushes at its quarters
LIFE_SPEC = dict(FLEET_SPEC, seed=17, arrival="mmpp", burstiness=3.0,
                 mmpp_switch=0.2, tenants=8)
LIFE_AVAILABILITY = 99.9


class _Stream:
    """A generated stream in the shape ``_teacher_forced`` reads."""

    def __init__(self, prompt, generated):
        import numpy as np
        self.request = type("Req", (), {})()
        self.request.prompt = np.asarray(prompt, np.int32)
        self.generated = [int(t) for t in generated]
        self.prompt_len = len(prompt)


def _path_launches(want: dict, tag: str) -> dict:
    """Every kernel's launches since the last reset; each kernel in
    ``want`` must show that many (None: more than 0), every other none."""
    from paddle_tpu_torch.ops import kernels
    got = {k["name"]: k["launches"] for k in kernels.kernels()}
    bad = {k: v for k, v in got.items()
           if (k in want and (v == 0 if want[k] is None else v != want[k]))
           or (k not in want and v)}
    _require(not bad, f"{tag}: launches {got}, expected {want}")
    return got


def _static_decode_case(B, L, H, D, pos):
    """Row 9 at ``generate``'s decode shape: the contiguous float32 buffer
    ``[B, L, H, D]`` read as ``L / STATIC_BLOCK`` pages a row, against its
    plain version, timed beside the bytes bound and SDPA over the same
    visible slots, L2 flushed before each launch as phase 2 times row 9
    (a step reads each layer's buffers once)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.models.gpt import STATIC_BLOCK
    from paddle_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention, paged_decode_plain)
    g = torch.Generator(device="cuda").manual_seed(20)
    kb, vb = (torch.randn(B, L, H, D, device="cuda", generator=g)
              for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g)
    n = L // STATIC_BLOCK
    pages = (B * n, STATIC_BLOCK, H, D)
    table = torch.arange(B * n, dtype=torch.int32, device="cuda").view(B, n)
    pos_t = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(D)
    args = (q, kb.view(pages), vb.view(pages), table, pos_t, scale)
    out = paged_decode_attention(*args)
    ref = paged_decode_plain(*args)
    err = (out - ref).abs().max().item()
    _require(err <= TOL["float32"], f"static decode: kernel against plain "
             f"{err} > {TOL['float32']}")
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = _median_ms(lambda: paged_decode_attention(*args), flush=scrub.zero_)
    plain_ms = _median_ms(lambda: paged_decode_plain(*args),
                          flush=scrub.zero_)
    vis = pos + 1
    qs = q[:, :, None]                                   # [B, H, 1, D]
    ks = kb[:, :vis].transpose(1, 2)
    vs = vb[:, :vis].transpose(1, 2)
    lib_ms = _median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                        flush=scrub.zero_)
    nbytes = B * vis * H * D * 4 * 2 + 2 * B * H * D * 4 \
        + table.numel() * 4 + B * 4
    bound, by = _bound_ms(nbytes, 4 * B * H * D * vis, "float32")
    _log(f"generate: row 9 (static) B={B} L={L} H={H} D={D} f32 at pos "
         f"{pos} (pages of {STATIC_BLOCK}): max|o-plain| {err:.3e}; "
         f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {bound:.4f} ({by}), "
         f"SDPA f32 over the {vis} visible slots {lib_ms:.4f} (L2 flushed)")


def _gen_part(model, cfg) -> tuple:
    """(a) ``generate`` greedy over the static cache: exact launches (row
    1 once a layer for the prefill, row 9 once a layer a step), every
    token a teacher-forced forward's pick (near-ties under ``TIE_GAP``)
    and the engine's greedy token; sampling in range and reproducible
    per seed; ms per decode step; row 9 timed at this shape. Returns the
    prompts, the greedy tokens and the launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import generate
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    rng = np.random.RandomState(20)
    prompts = rng.randint(0, cfg.vocab_size, (GEN_B, GEN_S0))
    prompts[:, -1] = GEN_LAST
    L = cfg.num_layers

    def run(new, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(model, prompts, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    run(2, decode_strategy="greedy_search")              # first use
    kernels.reset_launch_counts()
    out, wall = run(GEN_NEW, decode_strategy="greedy_search")
    launches = _path_launches({"flash_attention_fwd": L,
                               "paged_decode_attention": L * (GEN_NEW - 1)},
                              "generate")
    tokens = out[:, GEN_S0:].cpu().numpy()
    _require(tuple(out.shape) == (GEN_B, GEN_S0 + GEN_NEW)
             and out.dtype == torch.int32
             and (out[:, :GEN_S0].cpu().numpy() == prompts).all(),
             f"generate: output {tuple(out.shape)} {out.dtype}")
    _teacher_forced("generate", model,
                    [_Stream(p, t) for p, t in zip(prompts, tokens)],
                    TIE_GAP)
    full = sorted(run(GEN_NEW, decode_strategy="greedy_search")[1]
                  for _ in range(3))
    one = sorted(run(1, decode_strategy="greedy_search")[1]
                 for _ in range(3))
    step_ms = (full[1] - one[1]) / (GEN_NEW - 1) * 1e3
    _log(f"generate: B={GEN_B} S0={GEN_S0} {GEN_NEW} new tokens greedy in "
         f"{wall * 1e3:.1f} ms (first timed run); median of 3: "
         f"{full[1] * 1e3:.1f} ms for {GEN_NEW}, {one[1] * 1e3:.1f} ms for "
         f"the prefill and one token, so {step_ms:.3f} ms a decode step; "
         f"launches {launches}")
    busy = _profile_step("generate", lambda: run(
        GEN_NEW, decode_strategy="greedy_search"))
    _log(f"generate: device busy share {100 * busy:.2f}%")
    eng = ServingEngine(model, ServingConfig(**SERVE_CFG), device="cuda")
    eng.warmup()
    seqs = eng.generate([list(p) for p in prompts], max_new_tokens=GEN_NEW)
    eng.shutdown()
    del eng
    same = _same_streams("generate vs engine", model,
                         [t.tolist() for t in tokens],
                         [s[GEN_S0:].tolist() for s in seqs], prompts)
    _log(f"generate: {same} of {GEN_B} streams equal to the engine's greedy "
         "tokens (any other diverges at a near-tie)")
    draws = [run(GEN_NEW, decode_strategy="sampling", seed=s,
                 **GEN_SAMPLING)[0].cpu().numpy() for s in (1, 1, 2)]
    _require((draws[0] == draws[1]).all() and not (draws[0] ==
                                                   draws[2]).all()
             and draws[0].min() >= 0 and draws[0].max() < cfg.vocab_size,
             "generate: sampling not reproducible per seed or out of range")
    _log(f"generate: sampling at {GEN_SAMPLING}: seed 1 twice equal, seed 2 "
         f"differs, ids in [0, {cfg.vocab_size})")
    _static_decode_case(GEN_B, -(-(GEN_S0 + GEN_NEW) // 16) * 16,
                        cfg.num_heads, cfg.head_dim, GEN_S0 + GEN_NEW - 1)
    # row 1 (f32, causal) held against its plain version at the shapes
    # this phase gives it: generate's prefill, beam search's prefill
    # (one partial 64-row tile) and the teacher-forced references of
    # (a) and (b) (the longest top beam)
    for b, s in ((GEN_B, GEN_S0), (BEAM_B, GEN_S0 - 1),
                 (GEN_B, GEN_S0 + GEN_NEW), (1, GEN_S0 + BEAM_STEPS)):
        _flash_case(b, s, cfg.num_heads, cfg.head_dim, torch.float32,
                    seed=20 + s)
    return prompts, tokens, launches


def _beam_part(model, cfg, prompts, greedy) -> dict:
    """(b) ``dynamic_decode(BeamSearchDecoder)`` over a cell that runs the
    GPT one token a step over static caches, its states the caches and
    the position, reordered by parent. Prompts end in ``GEN_LAST``, so
    the cell prefills all but that token and the decoder starts from it.
    ``beam_size=1`` must give (a)'s greedy tokens; each top beam's score
    must be its teacher-forced log-probability within
    ``BEAM_SCORE_TOL``. Returns the launches of both decodes."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import STATIC_BLOCK, GPTAttention
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    from paddle_tpu_torch.ops import kernels
    B, S = BEAM_B, GEN_S0 - 1
    Lb = -(-(GEN_S0 + BEAM_STEPS) // STATIC_BLOCK) * STATIC_BLOCK
    ids = torch.from_numpy(prompts[:B].astype(np.int64)).cuda()

    def cell(inputs, states):
        pos = int(states["pos"][0])
        logits, caches = model(inputs[:, None], caches=states["caches"],
                               cache_pos=pos)
        return logits[:, -1], {"caches": caches, "pos": states["pos"] + 1}

    def decode(beam):
        caches = [GPTAttention.StaticCache(
            torch.zeros(B, Lb, cfg.num_heads, cfg.head_dim, device="cuda"),
            torch.zeros(B, Lb, cfg.num_heads, cfg.head_dim, device="cuda"))
            for _ in range(cfg.num_layers)]
        with torch.no_grad():
            _, caches = model(ids[:, :S], caches=caches, cache_pos=0)
            dec = BeamSearchDecoder(cell, start_token=GEN_LAST,
                                    end_token=BEAM_END, beam_size=beam)
            return dynamic_decode(
                dec, {"caches": caches,
                      "pos": torch.full((B,), S, device="cuda")},
                max_step_num=BEAM_STEPS, return_length=True)

    model.eval()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    out, final, lens = decode(BEAM_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    one, _, _ = decode(1)
    L = cfg.num_layers
    launches = _path_launches(
        {"flash_attention_fwd": 2 * L,
         "paged_decode_attention": 2 * L * BEAM_STEPS}, "beam")
    same = _same_streams("beam 1 vs generate", model,
                         one[:, :, 0].cpu().tolist(),
                         greedy[:B, :BEAM_STEPS].tolist(), prompts[:B])
    scores = final.log_probs.cpu().numpy()
    ids_top = out[:, :, 0].cpu().numpy()
    lens_top = lens[:, 0].cpu().numpy()
    worst = 0.0
    with torch.no_grad():
        for b in range(B):
            n = int(lens_top[b])
            seq = np.concatenate([prompts[b], ids_top[b, :n]])
            lp = torch.log_softmax(model(torch.from_numpy(
                seq[None].astype(np.int64)).cuda())[0].float(), dim=-1)
            tf = float(sum(lp[GEN_S0 - 1 + i, int(ids_top[b, i])]
                           for i in range(n)))
            worst = max(worst, abs(tf - float(scores[b, 0])))
    _require(worst <= BEAM_SCORE_TOL, f"beam: top score against its "
             f"teacher-forced log-probability {worst} > {BEAM_SCORE_TOL}")
    _require((np.diff(scores, axis=1) <= 1e-5).all(),
             f"beam: scores not sorted {scores}")
    _log(f"beam: B={B}, {BEAM_K} beams, {BEAM_STEPS} steps in "
         f"{wall * 1e3:.1f} ms; top scores {scores[:, 0].tolist()}, lengths "
         f"{lens_top.tolist()}; top score against the teacher-forced "
         f"log-probability {worst:.3e} (tol {BEAM_SCORE_TOL:g}); beam 1 "
         f"equal to generate's greedy tokens in {same} of {B} streams; "
         f"launches {launches}")
    return launches


def _fleet(model, n: int, flags: dict, router_kw=None, **cfg):
    from paddle_tpu_torch.serving import (FleetRouter, RouterConfig,
                                          ServingConfig, ServingEngine)
    with _flags(flags):
        reps = {}
        for i in range(n):
            eng = ServingEngine(model, ServingConfig(**dict(FLEET_CFG,
                                                            **cfg)),
                                device="cuda")
            eng.warmup()
            reps[f"r{i}"] = eng
        return FleetRouter(reps, RouterConfig(**(router_kw or FLEET_ROUTER)))


def _fleet_run(router, spec, parity=None) -> dict:
    """``run_fleet_open_loop`` timed on the host clock, then the parity
    prompts' greedy tokens. The summary gains ``wall_s`` and
    ``wall_tokens_per_sec``: the tokens over the run's own wall time,
    beside the JAX summary's busy-time model."""
    import torch
    from paddle_tpu_torch.serving import run_fleet_open_loop
    torch.cuda.synchronize()
    t = time.perf_counter()
    summary = run_fleet_open_loop(router, spec)
    torch.cuda.synchronize()
    summary["wall_s"] = time.perf_counter() - t
    summary["wall_tokens_per_sec"] = summary["tokens_generated"] \
        / summary["wall_s"]
    if parity is not None:
        summary["parity"] = [o[-8:].tolist() for o in router.generate(
            parity, max_new_tokens=8)]
    return summary


def _fleet_line(n, s) -> str:
    return (f"{n} replica{'s' * (n > 1)}: {s['requests_completed']} of "
            f"{s['requests_offered']} completed, {s['tokens_generated']} "
            f"tokens; wall {s['wall_s']:.3f} s, {s['wall_tokens_per_sec']:.2f}"
            f" tokens/s measured (one card, the replicas interleaved); "
            f"{s['aggregate_tokens_per_sec']:.2f} tokens/s by the JAX "
            f"summary's busy-time model (the busiest replica's busy seconds, "
            f"as if each replica had its own card); prefix hit "
            f"{s['fleet_prefix_hit_pct']:.2f}%; route decision p50 "
            f"{s['route_overhead_p50_s'] * 1e6:.1f} us, p99 "
            f"{s['route_overhead_p99_s'] * 1e6:.1f} us; availability "
            f"{s['availability_pct']:.2f}%; affine {s['routed_affine']}, "
            f"balanced {s['routed_balanced']}; busy s " + ", ".join(
                f"{k} {v['busy_s']:.3f}" for k, v in s["replicas"].items()))


def _fleet_part(model, cfg) -> dict:
    """(c) ``bench.py``'s fleet legs: the traffic through 1 and 4
    replicas (parity prompts token-identical, near-ties under
    ``TIE_GAP``), 4 replicas with a 1 Hz ``FleetFederator`` attached, and
    a ``kill_replica`` drill with every stream teacher-forced. Returns the
    launches of all four runs."""
    import numpy as np
    import torch
    from paddle_tpu_torch.monitor.fleet import (FederatorConfig,
                                                FleetFederator,
                                                local_registry_target)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (LoadSpec, SamplingParams,
                                          build_requests)
    spec = LoadSpec(sampling=SamplingParams(), **FLEET_SPEC)
    rng = np.random.default_rng(11)
    pre = rng.integers(0, cfg.vocab_size, (16,)).tolist()
    parity = [pre + rng.integers(0, cfg.vocab_size, (6,)).tolist(),
              pre + rng.integers(0, cfg.vocab_size, (4,)).tolist(),
              [3, 4, 5, 3, 4, 5, 3, 4]]
    flags = {"serve_prefix_cache": True}
    runs = {}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for n in FLEET_SIZES:
        router = _fleet(model, n, flags)
        try:
            runs[n] = _fleet_run(router, spec, parity)
        finally:
            router.shutdown()
        _log(f"fleet: {_fleet_line(n, runs[n])}")
        del router
        gc.collect()
    one, many = runs[FLEET_SIZES[0]], runs[FLEET_SIZES[-1]]
    router = _fleet(model, FLEET_SIZES[-1], flags)
    fed = FleetFederator([local_registry_target()],
                         FederatorConfig(interval_s=1.0), router=router,
                         port=0)
    fed.start()
    try:
        s = _fleet_run(router, spec)
        scrapes = fed.registry.get("fleet_scrapes_total")
        n_scrapes = sum(v for _, v in scrapes.samples()) if scrapes else 0
    finally:
        fed.close()
        router.shutdown()
    _log(f"fleet: with a 1 Hz FleetFederator attached ({n_scrapes:.0f} "
         f"scrapes): {_fleet_line(FLEET_SIZES[-1], s)}; wall tokens/s "
         f"{s['wall_tokens_per_sec']:.2f} against "
         f"{many['wall_tokens_per_sec']:.2f} without")
    del router, fed
    gc.collect()
    # the kill drill: the schedule submitted at once, a replica killed
    # after three passes; every stream must be a teacher-forced greedy
    # pick, the killed replica's continuations included
    router = _fleet(model, FLEET_SIZES[-1], flags)
    try:
        recs = [router.submit(req) for _, req in build_requests(spec)]
        for _ in range(3):
            router.step_all()
        live = {}
        for r in recs:
            if not r.done:
                live[r.replica] = live.get(r.replica, 0) + 1
        victim = max(live, key=live.get)
        streamed = {r.request_id: list(r.tokens) for r in recs}
        moved = router.kill_replica(victim)
        router.run()
        s = router.summary()
    finally:
        router.shutdown()
    _require(moved > 0 and s["migrated_death"] == moved
             and s["duplicate_request_ids"] == 0
             and s["requests_completed"] == s["requests_offered"] == len(recs)
             and all(r.tokens[:len(streamed[r.request_id])]
                     == streamed[r.request_id] for r in recs),
             f"fleet kill: {s}")
    _log(f"fleet: kill_replica({victim}) after 3 passes moved {moved} "
         f"requests; {s['requests_completed']} of {s['requests_offered']} "
         f"completed, 0 duplicate ids, availability "
         f"{s['availability_pct']:.2f}%")
    del router
    gc.collect()
    torch.cuda.synchronize()
    # read before the references below, whose no-cache forwards launch
    # the flash forward too
    launches = _path_launches({"flash_attention_fwd": None,
                               "flash_attention_bias_fwd": None,
                               "paged_decode_attention": None}, "fleet")
    _require(launches["paged_decode_attention"] % cfg.num_layers == 0,
             f"fleet: paged decode launches {launches}")
    _log(f"fleet: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
         f"({FLEET_SIZES[-1]} replicas' parameter copies and pools); "
         f"launches {launches}")
    checked = _teacher_forced("fleet kill", model, [
        _Stream(r.prompt, r.tokens) for r in recs], TIE_GAP)
    _log(f"fleet: the kill drill's {checked} tokens are teacher-forced "
         "greedy picks")
    for s in runs.values():
        _require(s["requests_completed"] == s["requests_offered"] ==
                 spec.num_requests and s["duplicate_request_ids"] == 0
                 and s["requests_in_flight"] == 0,
                 f"fleet: accounting {s}")
    same = _same_streams("fleet parity", model, many["parity"],
                         one["parity"],
                         [np.asarray(p, np.int32) for p in parity])
    _log(f"fleet: parity prompts {same} of {len(parity)} token-identical "
         f"between {FLEET_SIZES[0]} and {FLEET_SIZES[-1]} replicas; fleet "
         f"prefix hit {many['fleet_prefix_hit_pct']:.2f}% against the "
         f"single replica's {one['fleet_prefix_hit_pct']:.2f}%")
    torch.cuda.empty_cache()
    return launches


def _lifecycle_part(model, cfg, tmp: str) -> dict:
    """(d) ``bench.py``'s lifecycle drill: two hot-swap-armed replicas
    under its MMPP traffic, three identity pushes on every replica at the
    schedule's quarters; availability at least ``LIFE_AVAILABILITY``%,
    the accounting closed. Then a torn push refused with the old weights
    serving the same tokens, and a NaN candidate rolled back by the
    ``LifecycleController``. Returns the launches."""
    import torch
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (LifecycleConfig,
                                          LifecycleController, LoadSpec,
                                          SamplingParams, ServerOverloaded,
                                          WeightSwapError, build_requests)
    from paddle_tpu_torch.testing import chaos
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    router = _fleet(model, 2, {"serve_hot_swap": True,
                               "serve_traffic_split": True})
    push = os.path.join(tmp, "push")
    t = time.perf_counter()
    dckpt.save(dict(router.replicas["r0"].engine.params), push)
    save_s = time.perf_counter() - t
    spec = LoadSpec(sampling=SamplingParams(), **LIFE_SPEC)
    schedule = build_requests(spec)
    quarters = [len(schedule) // 4, len(schedule) // 2,
                3 * len(schedule) // 4]
    swaps, rejected, i, swap_s, pending = 0, 0, 0, [], 0
    try:
        t0 = time.perf_counter()
        while i < len(schedule) or any(
                r.alive and r.engine.scheduler.has_work
                for r in router.replicas.values()):
            now = time.perf_counter() - t0
            while i < len(schedule) and schedule[i][0] <= now:
                try:
                    router.submit(schedule[i][1])
                except ServerOverloaded:
                    rejected += 1
                i += 1
            if swaps < len(quarters) and i >= quarters[swaps]:
                for rep in router.replicas.values():
                    t = time.perf_counter()
                    info = rep.engine.swap_weights(push)
                    swap_s.append(time.perf_counter() - t)
                    pending += bool(info["pending"])
                    if not info["pending"]:
                        rep.engine.commit_swap()
                swaps += 1
            if not router.step_all() and i < len(schedule):
                wait = schedule[i][0] - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        wall = time.perf_counter() - t0
        s = router.summary()
        epochs = {n: r.engine.metrics_summary()["weights_epoch"]
                  for n, r in router.replicas.items()}
        lost = (s["requests_offered"] - s["requests_completed"]
                - s["requests_failed"] - s["requests_rejected"])
        _require(swaps == 3 and set(epochs.values()) == {3}
                 and s["availability_pct"] >= LIFE_AVAILABILITY and lost == 0
                 and s["requests_in_flight"] == 0
                 and s["duplicate_request_ids"] == 0,
                 f"lifecycle: swaps {swaps}, epochs {epochs}, lost {lost}, "
                 f"{s}")
        _log(f"lifecycle: 3 identity pushes x 2 replicas under MMPP (the "
             f"push {save_s:.3f} s to commit, "
             f"{_dir_bytes(push) / 1e9:.3f} GB): availability "
             f"{s['availability_pct']:.2f}%, {s['requests_completed']} "
             f"completed / {s['requests_failed']} failed / {rejected} "
             f"rejected of {s['requests_offered']}, 0 lost, 0 duplicate, "
             f"epochs {epochs}; {pending} of 6 swaps staged behind "
             f"in-flight slots; swap_weights s (verify, load, copy to the "
             f"card) " + ", ".join(f"{x:.3f}" for x in swap_s)
             + f"; run wall {wall:.3f} s, {s['tokens_generated']} tokens")
        eng = router.replicas["r0"].engine
        prompts = [[3, 4, 5, 3, 4, 5, 3, 4], list(range(100, 140))]
        want = [o.tolist() for o in eng.generate(prompts, max_new_tokens=8)]
        chaos.configure("serve.swap.torn_manifest@1")
        try:
            eng.swap_weights(push)
            _require(False, "lifecycle: a torn push was not refused")
        except WeightSwapError as e:
            reason = e.reason
        finally:
            chaos.reset()
        got = [o.tolist() for o in eng.generate(prompts, max_new_tokens=8)]
        _require(got == want and eng.metrics_summary()["weights_epoch"] == 3,
                 "lifecycle: the torn push changed the serving weights")
        _log(f"lifecycle: torn push refused ({reason}); the old weights "
             "serve the same tokens")
        with _flags({"serve_lifecycle": True}):
            ctrl = LifecycleController(router, LifecycleConfig(
                bake_window_s=30.0, min_requests=3,
                incident_dir=os.path.join(tmp, "incidents")))
        chaos.configure("serve.swap.bad_weights@1")
        try:
            out = ctrl.begin(push, candidate="r1")
        finally:
            chaos.reset()
        _require(out["state"] == "baking", f"lifecycle: begin {out}")
        recs = [router.submit(req) for _, req in build_requests(
            LoadSpec(sampling=SamplingParams(),
                     **dict(LIFE_SPEC, num_requests=10, seed=18)))]
        router.run()
        summ = ctrl.summary()
        _require(ctrl.state == "rolled-back"
                 and summ["decision"]["trigger"] == "nonfinite"
                 and all(r.outcome == "completed" for r in recs),
                 f"lifecycle: controller {ctrl.state} {summ['decision']}")
        got = [o.tolist() for o in router.replicas["r1"].engine.generate(
            prompts, max_new_tokens=8)]
        _require(got == want, "lifecycle: the rolled-back candidate serves "
                 "other tokens than the baseline")
        _log(f"lifecycle: NaN candidate on r1 rolled back by the controller "
             f"(trigger {summ['decision']['trigger']}, shadow outcomes "
             f"{summ['arms']['shadow']['outcomes']}); the baseline's 10 "
             f"requests completed; r1 serves the baseline's tokens again; "
             f"timeline {[e['to'] for e in ctrl.timeline]}")
    finally:
        router.shutdown()
    del router
    gc.collect()
    torch.cuda.synchronize()
    # the bench's lifecycle replicas run without the prefix cache, so no
    # context prefill
    launches = _path_launches({"flash_attention_fwd": None,
                               "paged_decode_attention": None},
                              "lifecycle")
    _log(f"lifecycle: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (two "
         f"replicas, a staged and a retired tree); launches {launches}")
    torch.cuda.empty_cache()
    return launches


def phase_fleet():
    """The rest of serving: ``generate`` and beam search over static
    caches, the fleet router with fleet monitoring and the kill drill,
    and weight pushes under load. Returns the launches of each path."""
    import tempfile
    import torch
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    cfg = gpt2_medium()
    model = GPTForPretraining(cfg, device="cuda", seed=0).eval()
    out = {}
    prompts, greedy, out["generate"] = _gen_part(model, cfg)
    out["beam"] = _beam_part(model, cfg, prompts, greedy)
    out["fleet"] = _fleet_part(model, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        out["lifecycle"] = _lifecycle_part(model, cfg, tmp)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- main --------------------------------------------------------------------
# -- phase 21: distributed ----------------------------------------------------
# four ranks on the one card over gloo (NCCL takes one card per rank),
# dp = 2 x mp = 2, ZeRO-1 over dp
DIST_RANKS, DIST_DP, DIST_MP = 4, 2, 2
# (c) parity: gpt2_medium widths at 2 layers, S = 1024, dropout 0.1,
# float32, a global batch of 4, two steps, against one process's step
DIST_PARITY_LAYERS, DIST_PARITY_B, DIST_PARITY_STEPS = 2, 4, 2
# the losses, relative: the ranks sum the row-parallel products, the
# vocab-parallel loss and the dp mean of the gradients in another order
# than one process does (float32, a few ulps of each sum)
DIST_LOSS_TOL = 1e-5
# every parameter after two AdamW steps at lr 1e-4, max abs: a step
# moves a weight by at most about lr (Adam's normalized update), and
# float32 reassociation moves the update by far less than a tenth of it.
# The key bias (qkv_bias[1]) is the exception: its gradient is 0 in
# exact arithmetic (a constant added to every score of a row), so what
# each side holds is reassociation noise of either sign, and Adam's first
# update divides it by its own magnitude: up to lr a step either way,
# 2 * lr * steps apart
DIST_PARAM_TOL = 1e-5
DIST_KEY_BIAS_TOL = 2 * TRAIN_LR * DIST_PARITY_STEPS
# (d) the timed run: gpt2_medium, B = 8 a call, S = 1024, O1, recompute,
# two microsteps an update, four updates
DIST_B, DIST_S, DIST_ACCUM, DIST_UPDATES = 8, 1024, 2, 4


def _dist_batch(B, S, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50304, (B, S)).astype(np.int32),
            rng.integers(0, 50304, (B, S)).astype(np.int32))


def _dist_offsets() -> None:
    """(a) Rows 1 and 3 with dropout 0.1 at [4, 1024, 16, 64] bf16: the
    launch on batch rows 2-3 and heads 8-15 with bases (2, 8) equals the
    whole launch's slice bit for bit (o, lse, dq, dk, dv), and holds its
    plain versions at phase 2's tolerance; row 8 over [4, 1024, 1024]
    from element base 2 * 1024 * 1024 equals the whole launch's rows and
    its plain version bit for bit."""
    import torch
    from paddle_tpu_torch.ops.kernels.dropout import (dropout_apply,
                                                      dropout_plain)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)
    B, S, H, D, rate = 4, 1024, 16, 64, 0.1
    words = (0x0F1E2D3C, 0x4B5A6978)
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, True, None, True, rate, words)
    grads = flash_attention_bwd(q, k, v, o, lse, do, True, None, rate, words)
    sl = (slice(2, 4), slice(None), slice(8, 16))
    qs, ks, vs, dos = (t[sl].contiguous() for t in (q, k, v, do))
    bases = dict(batch_base=2, head_base=8)
    os_, lses = flash_attention_fwd(qs, ks, vs, True, None, True, rate,
                                    words, **bases)
    gs = flash_attention_bwd(qs, ks, vs, os_, lses, dos, True, None, rate,
                             words, **bases)
    same = [torch.equal(os_, o[sl]), torch.equal(lses, lse[2:4, 8:16])] + [
        torch.equal(a, w[sl]) for a, w in zip(gs, grads)]
    _log("distributed: rows 1 and 3 on batch rows 2-3 and heads 8-15 of "
         f"[{B}, {S}, {H}, {D}] bf16 with bases (2, 8), dropout {rate}: "
         "bit-equal to the whole launches' slices (o, lse, dq, dk, dv) "
         f"{same}")
    _require(all(same), f"an offset launch differs from the whole "
             f"launch's slice: {same}")
    ref = flash_attention_plain(qs, ks, vs, True, None, False, rate, words,
                                mxu_dtype=torch.bfloat16, **bases)
    refs = flash_attention_bwd_plain(qs, ks, vs, os_, lses, dos, True, None,
                                     rate, words, mxu_dtype=torch.bfloat16,
                                     **bases)
    errs = [_rel_err(os_, ref)] + [_rel_err(a, r) for a, r in zip(gs, refs)]
    tol = TRAIN_FLASH_TOL["bfloat16"]
    _log(f"distributed: the offset launches against their plain versions "
         f"with the same bases (bf16 MXU operands): o {errs[0]:.3e}, dq "
         f"{errs[1]:.3e}, dk {errs[2]:.3e}, dv {errs[3]:.3e} (tol {tol:g})")
    _require(max(errs) <= tol, f"offset flash launches disagree with "
             f"their plain versions: {errs}")
    del q, k, v, do, o, lse, grads, gs, refs
    x = torch.randn(B, S, 1024, device="cuda",
                    generator=g).to(torch.bfloat16)
    whole = dropout_apply(x, rate, words)
    base = 2 * S * 1024
    part = dropout_apply(x[2:].contiguous(), rate, words, base)
    eq = (torch.equal(part, whole[2:]),
          torch.equal(part, dropout_plain(x[2:], rate, words, base)))
    _log(f"distributed: row 8 on rows 2-3 of [{B}, {S}, 1024] bf16 from "
         f"element base {base}: bit-equal to the whole launch's rows and "
         f"to its plain version {eq}")
    _require(all(eq), f"the offset dropout differs: {eq}")


def _dist_nccl() -> None:
    """(b) ``init_parallel_env()`` on the card picks NCCL; all_reduce,
    all_gather, broadcast and barrier go through it at world size 1."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.monitor import scoped_registry
    with scoped_registry() as reg:
        env = dist.init_parallel_env()
        _require(env.backend == "nccl" and env.world_size == 1,
                 f"init_parallel_env gave {env.backend} x {env.world_size}")
        t = torch.arange(8, dtype=torch.float32, device="cuda")
        want = t.clone()
        dist.all_reduce(t)
        got = dist.all_gather(t)
        dist.broadcast(t, src=0)
        dist.barrier()
        torch.cuda.synchronize()
        ops = {s[0]["op"]: s[1] for s in
               reg.get("comm_ops_total").samples()}
    ok = (torch.equal(t, want) and got.shape == (1, 8)
          and torch.equal(got[0], want))
    _log(f"distributed: NCCL at world size 1 (backend {env.backend}): "
         f"all_reduce, all_gather, broadcast, barrier through the process "
         f"group {ops}, values unchanged {ok}")
    _require(ok and set(ops) == {"all_reduce", "all_gather", "broadcast",
                                 "barrier"}, f"NCCL collectives {ops}")
    dist.destroy_process_group()


def _dist_model(layers, amp: bool, **cfg_kw):
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium)
    model = GPTForPretraining(gpt2_medium(num_layers=layers, **cfg_kw),
                              device="cuda", seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        if not amp:
            return crit(layer(ids), labels)
        with auto_cast(level="O1"):
            return crit(layer(ids), labels)
    return model, loss_fn


def _dist_step(dp, mp, layers, amp, step_kw=None, **cfg_kw):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(strategy=strategy, backend="gloo")
    hcg = fleet.get_hybrid_communicate_group()
    model, loss_fn = _dist_model(layers, amp, **cfg_kw)
    step = TrainStep(model, loss_fn, AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0, mesh=hcg.mesh, data_spec=P("dp"), zero_axis="dp",
        **(step_kw or {}))
    return step


def _dist_reference(path: str) -> list:
    """(c)'s reference: one process's float32 step on the same weights,
    batch and seed, on the card; its losses and parameters to ``path``."""
    import gc
    import torch
    from paddle_tpu_torch.framework.io import save
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    model, loss_fn = _dist_model(DIST_PARITY_LAYERS, amp=False)
    step = TrainStep(model, loss_fn, AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0)
    ids, labels = _dist_batch(DIST_PARITY_B, DIST_S, 5)
    losses = [float(step(ids, labels)) for _ in range(DIST_PARITY_STEPS)]
    save({"losses": losses, "params": step.state_dict()["params"]}, path)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _dist_parity(ref_path: str, rank: int, dp: int, mp: int) -> dict:
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import load
    step = _dist_step(dp, mp, DIST_PARITY_LAYERS, amp=False)
    ids, labels = _dist_batch(DIST_PARITY_B, DIST_S, 5)
    t0 = time.perf_counter()
    losses = [float(step(ids, labels)) for _ in range(DIST_PARITY_STEPS)]
    secs = time.perf_counter() - t0
    params = step.state_dict()["params"]
    out = {"losses": losses, "seconds": secs}
    if rank == 0:
        ref = load(ref_path)
        out["ref_losses"] = ref["losses"]
        errs = {k: float(np.abs(params[k] - v).max())
                for k, v in ref["params"].items()}
        key_bias = {k: float(np.abs(params[k][1] - v[1]).max())
                    for k, v in ref["params"].items()
                    if k.endswith("qkv_bias")}
        rest = {}
        for k, v in ref["params"].items():
            d = np.abs(params[k] - v)
            if k.endswith("qkv_bias"):
                d = np.delete(d, 1, axis=0)
            rest[k] = float(d.max())
        out.update(n_params=len(errs), keys_equal=set(params) == set(
            ref["params"]), worst=max(rest.items(), key=lambda kv: kv[1]),
            key_bias=max(key_bias.values()))
    fleet.reset()
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_timed(rank: int) -> dict:
    import gc
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.monitor import scoped_registry
    torch.cuda.reset_peak_memory_stats()
    step = _dist_step(DIST_DP, DIST_MP, 24, amp=True,
                      step_kw={"grad_accum_steps": DIST_ACCUM},
                      use_recompute=True)
    micro = [_dist_batch(DIST_B, DIST_S, 10 + i) for i in range(DIST_ACCUM)]
    losses, times, comm = [], [], []
    with scoped_registry() as reg:
        for _ in range(DIST_UPDATES):
            t0 = time.perf_counter()
            losses.append([float(step(*b)) for b in micro])
            times.append(time.perf_counter() - t0)
            c = 0.0
            for name in ("comm_latency_seconds",
                         "comm_cold_dispatch_seconds"):
                m = reg.get(name)
                c += sum(s[1]["sum"] for s in m.samples()) if m else 0.0
            comm.append(c)
        by_op = {}
        for name in ("comm_latency_seconds", "comm_cold_dispatch_seconds"):
            m = reg.get(name)
            for labels, st in (m.samples() if m else ()):
                key = f"{labels['op']}/{labels['group']}"
                by_op[key] = by_op.get(key, 0.0) + st["sum"]
    out = {"losses": losses, "times": times, "by_op": by_op,
           "comm": [b - a for a, b in zip([0.0] + comm, comm)],
           "peak": torch.cuda.max_memory_allocated(),
           "updates": step.step_count, "microsteps": step._micro_count}
    fleet.reset()
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_rank(out_dir: str) -> None:
    """One rank of phase 21's world (a spawned process: it imports no
    JAX and builds no kernel; phase 1's libraries load from
    ``paddle_tpu_torch/_build``). Writes ``rank<r>.pkl``."""
    import pickle
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops import kernels
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    ref = os.path.join(out_dir, "reference.pdparams")

    def launches():
        return {k["name"]: k["launches"] for k in kernels.kernels()}
    kernels.reset_launch_counts()
    res = {"parity": _dist_parity(ref, rank, DIST_DP, DIST_MP),
           "parity_dp": _dist_parity(ref, rank, DIST_RANKS, 1)}
    res["launches_parity"] = launches()
    kernels.reset_launch_counts()
    res["timed"] = _dist_timed(rank)
    res["launches"] = launches()
    res["leaked"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "paddle_tpu"))
    res["backend"] = dist.ParallelEnv().backend
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _dist_want(L: int) -> tuple:
    """One rank's launches in phase 21's world: (c) 2 steps of 2 layers
    at dp x mp (no chunked CE: the vocab-parallel loss is dense), the
    same at dp = 4 (the chunked CE once a step); then, counted apart,
    (d) 8 calls of L recomputed layers: the backward runs each block's
    forward again up to its last saved activation
    (``torch.utils.checkpoint``'s early stop), so row 1 and the first
    hidden dropout twice a layer, the second hidden dropout (after the
    MLP's last product) once. Returns (parity, timed)."""
    lp, n = DIST_PARITY_LAYERS, DIST_PARITY_STEPS
    calls = DIST_ACCUM * DIST_UPDATES
    zero = {k: 0 for k in ("paged_decode_attention",
                           "flash_attention_bias_fwd",
                           "flash_attention_bias_bwd_dq",
                           "flash_attention_bias_bwd_dkv",
                           "paged_decode_attention_quant", "bgmv",
                           "int8_matmul")}
    parity = dict(zero, flash_attention_fwd=2 * lp * n,
                  flash_attention_bwd=2 * lp * n,
                  fused_dropout=2 * 2 * (1 + 2 * lp) * n,
                  chunked_ce_lse=n, chunked_ce_dlogits=n)
    timed = dict(zero, flash_attention_fwd=2 * L * calls,
                 flash_attention_bwd=L * calls,
                 fused_dropout=(2 + 5 * L) * calls,
                 chunked_ce_lse=0, chunked_ce_dlogits=0)
    return parity, timed


def phase_distributed(smi: str) -> dict:
    """(a) the kernels' base offsets, (b) NCCL at world size 1, then a
    world of four ranks on the one card over gloo: (c) float32 parity
    at dp x mp and dp = 4 against one process, (d) the timed full-width
    O1 run. Returns the launches of (d) and those of (c), each summed
    over the ranks."""
    import pickle
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed.spawn_mod import spawn
    t = time.perf_counter()
    _dist_offsets()
    _dist_nccl()
    _log(f"distributed: (a) and (b) took {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ref = _dist_reference(os.path.join(tmp, "reference.pdparams"))
        _log(f"distributed: the one-process reference, losses "
             + " ".join(f"{x:.6f}" for x in ref)
             + f" ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        spawn("chip_smoke:_dist_rank", args=(tmp,), nprocs=DIST_RANKS)
        _log(f"distributed: the {DIST_RANKS}-rank world took "
             f"{time.perf_counter() - t:.1f} s (start, parity, timed run)")
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        _require(not res["leaked"], f"rank {r} imported {res['leaked'][:5]}")
        _require(res["backend"] == "gloo", f"rank {r}: {res['backend']}")
    for tag, layout in (("parity", f"dp={DIST_DP} x mp={DIST_MP}"),
                        ("parity_dp", f"dp={DIST_RANKS}")):
        p0 = ranks[0][tag]
        rel = max(abs(a - b) / abs(b) for r in ranks
                  for a, b in zip(r[tag]["losses"], p0["ref_losses"]))
        _log(f"distributed: (c) {layout}, ZeRO-1 over dp, f32, dropout 0.1, "
             f"gpt2_medium widths x {DIST_PARITY_LAYERS} layers, B="
             f"{DIST_PARITY_B} S={DIST_S}: losses " + " ".join(
                 f"{x:.6f}" for x in p0["losses"])
             + f" against one process's, largest relative difference "
             f"{rel:.3e} (tol {DIST_LOSS_TOL:g}); {p0['n_params']} gathered "
             f"parameters, worst {p0['worst'][0]} {p0['worst'][1]:.3e} "
             f"(tol {DIST_PARAM_TOL:g}), the key bias {p0['key_bias']:.3e} "
             f"(tol {DIST_KEY_BIAS_TOL:g}); {p0['seconds']:.2f} s for "
             f"{DIST_PARITY_STEPS} steps")
        _require(p0["keys_equal"], f"{tag}: the gathered state dict's keys")
        _require(rel <= DIST_LOSS_TOL, f"{tag}: losses differ by {rel}")
        _require(p0["worst"][1] <= DIST_PARAM_TOL
                 and p0["key_bias"] <= DIST_KEY_BIAS_TOL,
                 f"{tag}: parameters differ: {p0['worst']}, key bias "
                 f"{p0['key_bias']}")
    want_parity, want = _dist_want(24)
    for r, res in enumerate(ranks):
        _require(res["launches_parity"] == want_parity,
                 f"rank {r}: (c)'s launch counts {res['launches_parity']} "
                 f"!= {want_parity}")
        _require(res["launches"] == want,
                 f"rank {r}: (d)'s launch counts {res['launches']} != "
                 f"{want}")
    timed = [r["timed"] for r in ranks]
    first = [float(np.mean(x)) for x in timed[0]["losses"]]
    _require(all(np.isfinite(np.asarray(r["losses"])).all() for r in timed),
             "distributed: a non-finite loss")
    _require(all(r["losses"] == timed[0]["losses"] for r in timed),
             "distributed: the ranks report different losses")
    _require(first[-1] < first[0], f"distributed: loss did not decrease: "
             f"{first}")
    _require(all(r["updates"] == DIST_UPDATES and r["microsteps"] ==
                 DIST_UPDATES * DIST_ACCUM for r in timed),
             "distributed: update and microstep counts")
    step_s = float(np.median(timed[0]["times"]))
    comm = [float(np.median([c / w for c, w in zip(r["comm"], r["times"])]))
            for r in timed]
    tokens = DIST_B * DIST_S * DIST_ACCUM
    _log(f"distributed: (d) gpt2_medium dp={DIST_DP} x mp={DIST_MP}, "
         f"ZeRO-1, O1, recompute, B={DIST_B} S={DIST_S} a call, "
         f"{DIST_ACCUM} calls an update, {DIST_UPDATES} updates, four "
         f"ranks on one card with gloo collectives over host memory ({smi})"
         f": update losses (mean of the window) " + " ".join(
             f"{x:.4f}" for x in first)
         + f"; median update {step_s * 1e3:.1f} ms ({tokens / step_s:.1f} "
         f"tokens/s), updates " + " ".join(
             f"{x * 1e3:.1f}" for x in timed[0]["times"])
         + " ms; share in collectives (comm_* series, host time) by rank "
         + ", ".join(f"{100 * c:.1f}%" for c in comm)
         + "; peak memory by rank " + ", ".join(
             f"{r['peak'] / 2**30:.3f} GiB" for r in timed))
    _log("distributed: (d) rank 0's seconds in collectives over the "
         f"{DIST_UPDATES} updates by op/group: " + ", ".join(
             f"{k} {v:.2f}" for k, v in sorted(
                 timed[0]["by_op"].items(), key=lambda kv: -kv[1])))
    _log(f"distributed: launches a rank, (d) {ranks[0]['launches']}, (c) "
         f"{ranks[0]['launches_parity']} (each rank exactly the formula)")
    from paddle_tpu_torch.ops import kernels
    return tuple({k["name"]: sum(r[key][k["name"]] for r in ranks)
                  for k in kernels.kernels()}
                 for key in ("launches", "launches_parity"))


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

    card = timed("card", phase_card)
    rows = timed("kernels", phase_kernels)
    by_path = {}
    by_path["serve"], f32_serve = timed("slice", phase_slice)
    by_path["mt"] = timed("mt", phase_multitenant)
    timed("parity", phase_parity)
    amp_losses = timed("amp", phase_amp)
    by_path["train"] = timed("train", phase_train, amp_losses)
    timed("bert parity", phase_bert_parity)
    witness = timed("bert witness", phase_bert_witness)
    by_path["bert"], bert_step_s = timed("bert", phase_bert_train, witness)
    by_path["ernie"] = timed("ernie", phase_ernie)
    by_path["predict"] = timed("predict", phase_predict)
    by_path["amp_int8"] = timed("amp_int8", phase_amp_int8)
    by_path["bf16_serve"], bf16_serve = timed("bf16", phase_bf16_serve,
                                              f32_serve)
    by_path["chat"] = timed("chat", phase_chat)
    by_path["bf16_pools"] = timed("bf16 pools", phase_bf16_pools,
                                  bf16_serve)
    by_path["io_train"], by_path["io_predict"] = timed(
        "io", phase_io, bert_step_s)
    by_path["monitor_serve"], by_path["monitor_train"] = timed(
        "monitor", phase_monitor)
    by_path["resilience"], by_path["resilience_train"] = timed(
        "resilience", phase_resilience, (by_path["serve"], f32_serve))
    by_path.update(timed("fleet", phase_fleet))
    by_path["dist"], by_path["dist_parity"] = timed(
        "distributed", phase_distributed, card["smi"])
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
