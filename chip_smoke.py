#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``paddle_tpu``, and it has no
fallback: any failure raises and the script exits non-zero without its
result line. Twenty-four phases, in order:

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
              same float mask; every dropout base against the slice of
              the whole launch, bit for bit, and its plain version: rows
              2, 4 and 5 on batch rows 2-3 and heads 8-15 of [4, 512, 16,
              128] bf16 with a key bias, rows 1 and 3 on query rows 256-
              511 (row base) and key columns 512-767 (column base) of [2,
              1024, 8, 64] in both dtypes, row 8 on a sequence shard with
              its row stride; rows 2, 4 and 5 at a BASELINE config 5
              rank's shape ([4, 512, 8, 128], one row padded from 384,
              bases (4, 8)) in f32 and bf16, timed in bf16 against SDPA;
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
              ``request_failed``; decode p50/p99 and tokens/s off and
              on; (b) phase 10's BERT-base
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
              to the whole launch's rows; rows 1, 3, 6-8 at the shapes
              and bases the pipeline of (f) and (g) gives them, held to
              their plain versions; (b) ``init_parallel_env()`` on
              the card (NCCL at world size 1) with all_reduce, all_gather,
              broadcast and barrier; then four ranks spawned on the one
              card over gloo (NCCL takes one card per rank), which load
              phase 1's libraries and build nothing: (c) float32 parity at
              dp = 2 x mp = 2 and at dp = 4, ZeRO-1 over dp, dropout 0.1,
              gpt2_medium widths at 2 layers, S = 1024, two steps: the
              losses and the gathered parameters against one process's
              TrainStep on the same weights, batch and seed; (d) the full
              gpt2_medium at dp = 2 x mp = 2, O1, recompute, ZeRO-1,
              B = 8 a call, two calls an update, two updates: losses
              finite and falling, the median update, the share of it in
              collectives (the ``comm_*`` series), peak memory per rank
              and each rank's launches exactly the formula; the
              pipeline: (e) gloo's own point-to-point ops on CUDA tensors
              (pairs of processes of their own) and the port's handoff
              in the world; (f) float32 parity at pp = 2 x mp = 2 and
              pp = 4, gpt2_medium widths x 4 layers, 4 microbatches,
              fill-drain and 1F1B, against one process's TrainStep, 1F1B
              bit-equal to fill-drain; (g) BASELINE config 4's model
              (gpt2_medium at pp = 2 x mp = 2, B = 8 in 8 microbatches,
              O1): two updates of ``pretraining_loss`` under 1F1B, then
              two of config 4's ``crit(layer(ids), labels)``, each with
              losses finite and falling, the median update, the
              collective split, peak memory, in-flight maxima equal to
              the timetable's and launches exactly the formula; (h)
              sequence parallelism: ring and Ulysses attention over sp
              = 4 on [2, 4096, 16, 64] bf16, causal, dropout 0.1,
              against one process's rows 1 and 3 on the whole sequence,
              timed with the share in their pinned-host hops and
              all-to-alls, and float32 parity of a sequence-parallel GPT
              (gpt2_medium widths x 2 layers, S = 1024, dropout 0.1, two
              steps) at sp = 2 x mp = 2 and sp = 4 against one process's
              TrainStep; (i) BASELINE config 5's model, ERNIE-3.0 1.5B,
              built a layer at a time into each rank's blocks and laid
              out by ``apply_hybrid_specs`` at sharding = 2 x mp = 2
              (dp cut from n/4 to 1), O1, AdamW (peak lr 1e-4 after a
              linear warmup), ZeRO over sharding,
              dropout 0.1, B = 8, S = 512, 76 masked positions, the last
              row padded from 384: the rank's blocks, one warm-up and
              two updates with losses finite, falling and equal on
              every rank, the median update, tokens/s, the collective
              split, peak memory and launches exactly the formula; (j)
              config 5's widths at 2 layers saved sharded at sharding =
              2 x mp = 2 and resumed at the same layout (bit-exact), at
              mp = 4 and in one process (within ``RESHARD_TOL``); every
              rank checks that it imported no JAX;
22. vision -- (a) BASELINE config 1: LeNet eager at B = 64 with
              ``Momentum(0.01)``, ms a step (median of 3 runs of 10
              steps), then 4 epochs of synthetic MNIST through
              ``io.DataLoader`` with the last 3 losses' mean under the
              first 3's; (b) BASELINE config 2: ResNet-50 at B = 256,
              [3, 224, 224], 1000 classes, AMP O1, ``Momentum(0.1, 0.9,
              weight_decay=1e-4)`` through ``TrainStep`` on a batch
              resident on the card, channels-last by
              ``FLAGS_jit_channels_last`` and again with it off: ms a
              step, img/s and MFU on ``bench.py``'s count, peak memory,
              the busy share and device time by group of one profiled
              step, losses finite, BN statistics moved, the JAX
              state-dict layout; (c) ResNet-18 f32 [4, 3, 64, 64], two
              ``TrainStep`` steps on the card and on the CPU from the
              same weights (losses, parameters, BN buffers, gradients per
              tensor in L2), and the port's f32 conv bit-equal under
              ``cudnn.allow_tf32`` on and off beside PyTorch's TF32 gap;
              (d) VGG-16 O1 at B = 16, three steps, both classifier
              dropouts through the fused dropout kernel (row 8 exactly
              twice a dropout a step; (a)-(c) launch no kernel of the
              port); (e) ``inference.passes.fold_conv_bn`` on (b)'s
              ResNet-50 in eval: 53 pairs, the folded logits against the
              unfolded;
23. moe    -- ``bench.py --moe``'s GPT-2 345M-8E (gpt2_medium, 8
              experts of ffn_size hidden in every second layer, top-2 at
              capacity factor 2): (a) ten ``TrainStep`` steps at
              ``bench_gpt2_345m``'s configuration (B = 8, S = 1024, O1,
              dropout 0.1, AdamW) on ``crit + moe_loss`` with launches
              exactly the dense step's formula, step time, tokens/s,
              peak memory, a profiled step's device time by group
              (routing, dispatch/combine, expert matmuls, flash, CE,
              dropout, optimizer) and the router health of one eager
              forward; (b) one forward and backward under the sort and
              the einsum dispatch from the same parameters and seed words
              (loss and gradients within phase 6's limits) and each
              path's dispatch plus combine timed at T = 8192; (d)
              ``generate`` greedy over the static cache on (a)'s model at
              capacity factor E with exact launches, every token the full
              forward's argmax (near-ties under ``TIE_GAP``), then phase
              3's first 8 requests through ``ServingEngine``,
              teacher-forced, decode p50, exact launches; (c) ep = 4 over
              four ranks on the one card (gloo), gpt2_medium widths x 4
              layers: float32 parity at capacity factor E against one
              process's steps (losses, gathered parameters), the update
              time, the collectives' seconds by op, peak memory a rank,
              one O1 step, launches exactly the formula;
24. vision2 -- (a) ResNet-18 f32 [16, 3, 64, 64] at dp = 4 over four
              ranks on the one card (gloo), two Momentum steps through
              ``TrainStep`` with every BatchNorm's statistics over the
              global batch, against one process's step (losses,
              parameters, running statistics; both equal on every rank);
              (b) BASELINE config 2 through ``hapi.Model.fit`` under
              ``fleet.init`` in the same world: ResNet-50, every BN
              converted to ``SyncBatchNorm``, global batch 256 (64 a
              rank), 224^2, AMP O1, channels-last, Momentum(0.9) under a
              cosine schedule stepped by the ``LRScheduler`` callback:
              ms an update, img/s, the share in collectives split into
              the BN statistics collectives and the gradient all-reduce,
              peak memory a rank, rank 0's profiled update; losses,
              running statistics, parameters and ``evaluate``'s
              ``Accuracy`` equal on every rank; (c)
              ``max_pool2d(return_mask=True)`` -> ``MaxUnPool2D`` at
              ResNet's stem, (d) the detection ops at their published
              widths (SSD300 priors, decode and multi-class NMS;
              YOLOv3-608's three heads; Mask R-CNN's ``roi_align`` on P2,
              FPN anchors and proposal routing; R-FCN's ``psroi_pool``;
              ``nms`` on 1000 boxes; DCNv2's ``deform_conv2d`` on res5)
              and (e) ``QuantizedConv2D`` forward and backward at a res3
              conv, each card against the port's own CPU run and timed;
              no part launches a kernel of the port, and every rank
              checks that it imported no JAX;
25. summary -- print one JSON line describing every ported kernel, then
              the result line ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each of phases 3, 4, 7, 10, 11,
13, 14 and 15, before each engine of phase 16, before the fed run of
phase 17, before each predictor of phases 12 and 17, before each half
of phase 18, before each run of phase 19, before each part of phase
20 and, in each rank of phase 21's world, before its parity runs and
again before its timed run, its pipeline parity runs, each of its two
pipeline loss styles, (h)'s attention calls and each of its parity
layouts, and (i)'s timed updates, and before phase 22, before phase 23's
(a), (d)'s two runs and, in each rank, (c), before phase 24's (c) and,
in each rank, (a), and read just
after each (a witness's
reference runs are taken back out of them, and phase 20 reads them
before its teacher-forced references);
the kernel JSON line gives each kernel's launches per path (``serve``,
``mt``, ``train``, ``bert``, ``ernie``, ``predict``, ``amp_int8``,
``bf16_serve``, ``chat``, ``bf16_pools``, ``io_train``, ``io_predict``,
``monitor_serve``, ``monitor_train``, ``resilience``,
``resilience_train``, ``generate``, ``beam``, ``fleet``,
``lifecycle``, ``dist``: phase 21's timed run, ``dist_parity``: its
float32 parity runs, ``pipe`` and ``pipe_forward``: (g) under 1F1B and
in config 4's loss style, ``pipe_parity``: (f), ``ring``: (h)'s one
counted ring and Ulysses call, ``sp_parity``: (h)'s sequence-parallel
GPT runs, ``ernie_hybrid``: (i)'s two updates, each summed over the
world's ranks; ``vision``: phase 22, whose launches are all (d)'s;
``moe``: phase 23 (a)'s ten steps, ``moe_ep``: (c) summed over its
ranks, ``moe_decode``: (d)'s generate and serving runs; ``vision2``:
phase 24, its ranks' (a) and (b) and its own (c)-(e), all 0).
Each phase prints its seconds, and the run its total.

Without a CUDA device, or in a directory that holds this script and
nothing else of the repository, it exits non-zero and prints no result.

``tools/run_chip_phase.py monitor|fleet|distributed|vision|moe|vision2``
runs phase 1 and phase 18, 20, 21, 22, 23 or 24 alone.
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


def _dropout_case(dtype, timed=False, B=TRAIN_B, base=0):
    """Bit-equal to the plain version at the residual stream's shape (``B``
    rows, the mask from element ``base`` on)."""
    import torch
    from paddle_tpu_torch.ops.kernels.dropout import (dropout_apply,
                                                      dropout_plain)
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(B, TRAIN_S, 1024, device="cuda", generator=g).to(dtype)
    words = (0x12345678, 0x9ABCDEF0)
    y = dropout_apply(x, 0.1, words, base)
    equal = torch.equal(y, dropout_plain(x, 0.1, words, base))
    kept = (y != 0).float().mean().item()
    _log(f"kernels: fused_dropout {tuple(x.shape)} {_name(dtype)} rate 0.1"
         + (f" from element base {base}" if base else "")
         + f": bit-equal to plain {equal}, kept {kept:.5f}")
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


def _ce_case(dtype, timed=False, N=TRAIN_B * TRAIN_S):
    """lse and dlogits at the LM head's [N = B*S, V] against the plain
    versions; returns the two rows when timed."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import chunked_ce as ce
    V = 50304
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


def _flash_train_case(dtype, timed=False, B=TRAIN_B, H=16, batch_base=0,
                      head_base=0):
    """Forward with dropout and backward at the training shapes (or at
    ``B`` rows of ``H`` heads, the mask that of batch rows
    ``batch_base..`` and heads ``head_base..``), against the plain
    versions; the backward's is fed the kernel's o and lse, so only the
    order of summation and the output rounding differ."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)
    S, D, rate = TRAIN_S, 64, 0.1
    words = (0x2468ACE0, 0x13579BDF)
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    name = _name(dtype)
    bases = dict(batch_base=batch_base, head_base=head_base)
    o, lse = flash_attention_fwd(q, k, v, True, None, True, rate, words,
                                 **bases)
    o_err = _rel_err(o, flash_attention_plain(q, k, v, True, None, False,
                                              rate, words, **bases))
    grads = flash_attention_bwd(q, k, v, o, lse, do, True, None, rate, words,
                                **bases)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, True, None, rate,
                                     words, **bases)
    errs = [_rel_err(a, r) for a, r in zip(grads, refs)]
    mxu = _mxu_errs((o,), lambda: (flash_attention_plain(
        q, k, v, True, None, False, rate, words,
        mxu_dtype=torch.bfloat16, **bases),), dtype)
    mxu += _mxu_errs(grads, lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, True, None, rate, words,
        mxu_dtype=torch.bfloat16, **bases), dtype)
    where = (f", bases ({batch_base}, {head_base})"
             if batch_base or head_base else "")
    _log(f"kernels: flash B={B} S={S} H={H} D={D} {name} causal dropout "
         f"{rate}{where}: o {o_err:.3e}, dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
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
    # q, k, v, o, dO read and dq, dk, dv written; lse read. In f32 the
    # bound takes three TF32 tensor-core products an f32 product, as the
    # f32 forward's; the CUDA-core rate's bound is kept beside it
    bwd_bytes = 8 * B * S * H * D * elem + B * H * S * 4
    bwd_ops = 10 * B * H * D * pairs
    b_bwd, by_bwd = _bound_ms(bwd_bytes, bwd_ops, "float32_3xtf32"
                              if name == "float32" else name)
    shape = f"B={B} S={S} H={H} D={D} {name} causal dropout {rate}"
    if name == "float32":
        shape += (f" (bound at the CUDA cores' f32 rate "
                  f"{_bound_ms(bwd_bytes, bwd_ops, name)[0]:.4f} ms)")
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
                     timed=False, full_row=None, batch_base=0, head_base=0):
    """The biased forward with dropout and its dq and dk/dv/dbias
    kernels against their plain versions (the backward's fed the
    kernel's o and lse); with ``full_row`` that batch row is fully
    masked and must give o = 0 and lse = -1e30; the dropout mask that of
    batch rows ``batch_base..`` and heads ``head_base..``."""
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
    bases = dict(batch_base=batch_base, head_base=head_base)
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, False, None, True,
                                         rate, words, **bases)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, False, None, True,
                                              rate, words, bias, **bases)
    errs = {"o": _rel_err(o, o_ref)}
    lse_err = (lse - lse_ref).abs().max().item()
    mxu = _mxu_errs((o,), lambda: (fa.flash_attention_plain(
        q, k, v, False, None, False, rate, words, bias,
        mxu_dtype=torch.bfloat16, **bases),), dtype)
    dq = fa.flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args,
                                        **bases)
    dk, dv, db = fa.flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                                 *args, **bases)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                        bias=bias, **bases)
    errs.update((n, _rel_err(a, r)) for n, a, r in
                zip(("dq", "dk", "dv", "db"), (dq, dk, dv, db), refs))
    del refs
    mxu += _mxu_errs((dq, dk, dv), lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, *args, bias=bias,
        mxu_dtype=torch.bfloat16, **bases)[:3], dtype)
    tol = TRAIN_FLASH_TOL[name]
    shape = (f"B={B} S={S} H={H} D={D} {name} key bias "
             f"({int((mask == 0).any(1).sum())} padded rows) dropout {rate}"
             + (f", bases ({batch_base}, {head_base})"
                if batch_base or head_base else ""))
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
                                                True, rate, words, **bases),
            lambda: fa.flash_attention_plain(q, k, v, False, None, True,
                                             rate, words, bias, **bases)),
        "flash_attention_bias_bwd_dq": (
            errs["dq"], b_dq, bwd_lib,
            lambda: fa.flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do,
                                                   *args, **bases),
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                                 bias=bias, **bases)),
        "flash_attention_bias_bwd_dkv": (
            max(errs["dk"], errs["dv"], errs["db"]), b_dkv, bwd_lib,
            lambda: fa.flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse,
                                                    do, *args, **bases),
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *args,
                                                 bias=bias, **bases))}
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


def _bases_case() -> None:
    """Every dropout base of rows 1-5 and 8 against the matching slice of
    the whole launch, bit for bit, and the base launches against their
    plain versions (phase 2's tolerances): rows 2, 4 and 5 on batch rows
    2-3 and heads 8-15 of [4, 512, 16, 128] bf16 with a padded key bias
    and bases (2, 8) (o, lse, dq, dk, dv; db sums the heads, so it is
    held to its plain version); rows 1 and 3, non-causal, on [2, 1024, 8,
    64] in both dtypes: query rows 256-511 with row base 256 (o, lse,
    dq), and key columns 512-767 with column base 512 given the whole
    launch's o and lse (dk, dv: a ring block's backward); row 8 on
    positions 256-511 of every row of [4, 1024, 1024] bf16 with the row
    stride (a sequence shard)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels.dropout import (dropout_apply,
                                                      dropout_plain)
    rate, words = 0.1, (0x5A5A1234, 0x0C0FFEE0)
    g = torch.Generator(device="cuda").manual_seed(31)
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(4, 512, 16, 128, device="cuda", generator=g)
                   .to(bf) for _ in range(4))
    mask = np.ones((4, 512), np.int32)
    mask[1, 300:] = 0
    mask[3, 384:] = 0
    bias = _key_bias(mask, bf)
    args = (False, None, rate, words)
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, False, None, True,
                                         rate, words)
    dq = fa.flash_attention_bias_bwd_dq(q, k, v, bias, o, lse, do, *args)
    dk, dv, _ = fa.flash_attention_bias_bwd_dkv(q, k, v, bias, o, lse, do,
                                                *args)
    sl = (slice(2, 4), slice(None), slice(8, 16))
    qs, ks, vs, dos = (t[sl].contiguous() for t in (q, k, v, do))
    bs = bias[2:4].contiguous()
    bases = dict(batch_base=2, head_base=8)
    os_, lses = fa.flash_attention_bias_fwd(qs, ks, vs, bs, False, None,
                                            True, rate, words, **bases)
    dqs = fa.flash_attention_bias_bwd_dq(qs, ks, vs, bs, os_, lses, dos,
                                         *args, **bases)
    dks, dvs, dbs = fa.flash_attention_bias_bwd_dkv(qs, ks, vs, bs, os_,
                                                    lses, dos, *args,
                                                    **bases)
    same = [torch.equal(os_, o[sl]), torch.equal(lses, lse[2:4, 8:16]),
            torch.equal(dqs, dq[sl]), torch.equal(dks, dk[sl]),
            torch.equal(dvs, dv[sl])]
    ref = fa.flash_attention_plain(qs, ks, vs, False, None, False, rate,
                                   words, bs, mxu_dtype=bf, **bases)
    refs = fa.flash_attention_bwd_plain(qs, ks, vs, os_, lses, dos, *args,
                                        bias=bs, mxu_dtype=bf, **bases)
    errs = [_rel_err(a, r) for a, r in zip((os_, dqs, dks, dvs, dbs),
                                           (ref,) + tuple(refs))]
    _log("kernels: rows 2, 4, 5 on batch rows 2-3 and heads 8-15 of [4, "
         "512, 16, 128] bf16 (key bias, 2 padded rows, dropout 0.1) with "
         f"bases (2, 8): bit-equal to the whole launches' slices (o, lse, "
         f"dq, dk, dv) {same}; against their plain versions o, dq, dk, dv, "
         "db " + ", ".join(f"{e:.3e}" for e in errs) + " (tol "
         f"{TRAIN_FLASH_TOL['bfloat16']:g}, db {TRAIN_FLASH_TOL['float32']:g})")
    _require(all(same), f"a biased launch with bases differs from the "
             f"whole launch's slice: {same}")
    _require(max(errs[:4]) <= TRAIN_FLASH_TOL["bfloat16"]
             and errs[4] <= TRAIN_FLASH_TOL["float32"],
             f"biased launches with bases against their plain versions: "
             f"{errs}")
    del q, k, v, do, o, lse, dq, dk, dv, qs, ks, vs, dos, refs
    for dtype in (bf, torch.float32):
        q, k, v, do = (torch.randn(2, 1024, 8, 64, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, *args[:2], True, rate,
                                        words)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, *args)
        r, c = slice(256, 512), slice(512, 768)
        qr, dor, or_ = (t[:, r].contiguous() for t in (q, do, o))
        lser = lse[:, :, r].contiguous()
        o2, lse2 = fa.flash_attention_fwd(qr, k, v, False, None, True, rate,
                                          words, row_base=256)
        dq2, _, _ = fa.flash_attention_bwd(qr, k, v, or_, lser, dor, *args,
                                           row_base=256)
        kc, vc = (t[:, c].contiguous() for t in (k, v))
        _, dk2, dv2 = fa.flash_attention_bwd(q, kc, vc, o, lse, do, *args,
                                             col_base=512)
        same = [torch.equal(o2, o[:, r]), torch.equal(lse2, lse[:, :, r]),
                torch.equal(dq2, dq[:, r]), torch.equal(dk2, dk[:, c]),
                torch.equal(dv2, dv[:, c])]
        mx = bf if dtype == bf else None
        oc, _ = fa.flash_attention_fwd(q, kc, vc, False, None, True, rate,
                                       words, col_base=512)
        errs = [_rel_err(o2, fa.flash_attention_plain(
                    qr, k, v, False, None, False, rate, words, mxu_dtype=mx,
                    row_base=256)),
                _rel_err(oc, fa.flash_attention_plain(
                    q, kc, vc, False, None, False, rate, words,
                    mxu_dtype=mx, col_base=512))]
        refs = fa.flash_attention_bwd_plain(q, kc, vc, o, lse, do, *args,
                                            mxu_dtype=mx, col_base=512)
        errs += [_rel_err(dk2, refs[1]), _rel_err(dv2, refs[2])]
        tol = TRAIN_FLASH_TOL[_name(dtype)]
        _log(f"kernels: rows 1 and 3, [2, 1024, 8, 64] {_name(dtype)} "
             "non-causal, dropout 0.1: query rows 256-511 with row base "
             "256 and key columns 512-767 with column base 512: bit-equal "
             f"to the whole launches' slices (o, lse, dq, dk, dv) {same}; "
             "against their plain versions (o of the rows, o of the "
             "columns, dk, dv) " + ", ".join(f"{e:.3e}" for e in errs)
             + f" (tol {tol:g})")
        _require(all(same), f"a launch with row or column bases differs "
                 f"from the whole launch's slice in {_name(dtype)}: {same}")
        _require(max(errs) <= tol, f"launches with row or column bases "
                 f"against their plain versions: {errs}")
        del q, k, v, do, o, lse, dq, dk, dv, refs
    x = torch.randn(4, 1024, 1024, device="cuda", generator=g).to(bf)
    whole = dropout_apply(x, rate, words)
    shard = dict(base=256 * 1024, row_len=256 * 1024,
                 row_stride=1024 * 1024)
    xs = x[:, 256:512].contiguous()
    part = dropout_apply(xs, rate, words, **shard)
    eq = (torch.equal(part, whole[:, 256:512]),
          torch.equal(part, dropout_plain(xs, rate, words, **shard)))
    _log("kernels: row 8 on positions 256-511 of [4, 1024, 1024] bf16 with "
         "the row stride (a sequence shard): bit-equal to the whole "
         f"launch's slice and to its plain version {eq}")
    _require(all(eq), f"the row-strided dropout differs: {eq}")
    torch.cuda.empty_cache()


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
    # row 3 (f32): the CUDA-core backward at a rank's shape in phase 21's
    # f32 parity runs (dp = 2 x mp = 2: 2 rows, 8 heads)
    more_rows["flash_attention_bwd float32"] = _flash_train_case(
        torch.float32, timed=True, B=2, H=8)["flash_attention_bwd"]
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
    # a BASELINE config 5 rank's attention (ERNIE-3.0 1.5B at sharding =
    # 2 x mp = 2: 4 rows, 8 of 16 heads, D = 128, one row padded from
    # 384), with the bases of sharding rank 1, mp rank 1; timed in bf16
    m5 = np.ones((4, 512), np.int32)
    m5[3, 384:] = 0
    _bias_flash_case(4, 512, 8, 128, torch.float32, m5, seed=12,
                     batch_base=4, head_base=8)
    for kname, r in _bias_flash_case(4, 512, 8, 128, torch.bfloat16, m5,
                                     seed=12, timed=True, batch_base=4,
                                     head_base=8).items():
        more_rows[f"{kname} bfloat16 D=128"] = r
    torch.cuda.empty_cache()
    _bases_case()
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
              lambda q, k, v, bias, *a, **kw: fa.flash_attention_plain(
                  q, k, v, *a, bias=bias, mxu_dtype=op(q), **kw)),
             (fa, "flash_attention_bias_bwd_dq",
              lambda q, k, v, bias, o, lse, do, *a, **kw:
              fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *a,
                                           bias=bias, mxu_dtype=op(q),
                                           **kw)[0]),
             (fa, "flash_attention_bias_bwd_dkv",
              lambda q, k, v, bias, o, lse, do, *a, **kw:
              fa.flash_attention_bwd_plain(q, k, v, o, lse, do, *a,
                                           bias=bias, mxu_dtype=op(q),
                                           **kw)[1:]))
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


def _profile_step(tag: str, fn, groups=PROFILE_GROUPS,
                  step_ms=None) -> float:
    """Device time by kernel over one more call of ``fn`` (a step or a
    predictor run; torch.profiler), as ``tools/profile_torch_serve.py``
    reads it. Returns the device busy share of the call (summed kernel
    time over its wall time; one stream, so kernels never overlap).
    ``step_ms``, the call's unprofiled time, also prints the busy time's
    share of it (the profiler's own host cost left out)."""
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
    if step_ms is not None:
        _log(f"{tag}: kernels busy {100 * busy / step_ms:.1f}% of the "
             f"unprofiled median step ({step_ms:.3f} ms)")
    by_group = {}
    for a in dev:
        group = next((g for g, keys in groups
                      if any(k in a.key for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + a.self_device_time_total
    _log(f"{tag}: device time by group: " + ", ".join(
        f"{g} {us / 1e3:.1f} ms ({100 * us / 1e3 / max(busy, 1e-9):.1f}%)"
        for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])))
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
    ckpt.save_train_step(step, path, asynchronous=False)
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
    dckpt.save(dict(router.replicas["r0"].engine.params), push,
               asynchronous=False)
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
# two microsteps an update, two updates (four until phase 24 needed the
# script's time)
DIST_B, DIST_S, DIST_ACCUM, DIST_UPDATES = 8, 1024, 2, 2


def _dist_batch(B, S, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50304, (B, S)).astype(np.int32),
            rng.integers(0, 50304, (B, S)).astype(np.int32))


def _comm_by_op(reg) -> dict:
    """Host seconds in collectives so far by ``op/group``: the
    ``comm_*`` series of the registry ``reg``."""
    by_op = {}
    for name in ("comm_latency_seconds", "comm_cold_dispatch_seconds"):
        m = reg.get(name)
        for labels, st in (m.samples() if m else ()):
            key = f"{labels['op']}/{labels['group']}"
            by_op[key] = by_op.get(key, 0.0) + st["sum"]
    return by_op


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


def _pipe_kernel_shapes() -> None:
    """(a) Each kernel of (f) and (g) at the shapes and bases the pipeline
    gives it, against its plain version at phase 2's tolerances: a
    microbatch is one row, so rows 1 and 3 run on [1, 1024, H/mp, 64]
    from batch base m (the microbatch) and head base mp_rank * H/mp;
    (g)'s bf16 on stage 1, mp rank 1, microbatch 7, (f)'s f32 on its
    last microbatch, 3, at pp = 2 x mp = 2 (8 heads from 8) and pp = 4
    (16 heads from 0); row 8 on [1, 1024, 1024] from (g)'s element base
    7 * 1024 * 1024, in both dtypes (O1 drops bf16 and f32 activations);
    rows 6 and 7 on pp = 4's last stage, a microbatch's N = 1024 rows
    over V = 50304, f32."""
    import torch
    _flash_train_case(torch.bfloat16, B=1, H=8, batch_base=PIPE_M - 1,
                      head_base=8)
    _flash_train_case(torch.float32, B=1, H=8,
                      batch_base=PIPE_PARITY_M - 1, head_base=8)
    _flash_train_case(torch.float32, B=1, H=16,
                      batch_base=PIPE_PARITY_M - 1)
    for dtype in (torch.bfloat16, torch.float32):
        _dropout_case(dtype, B=1, base=(PIPE_M - 1) * DIST_S * 1024)
    _ce_case(torch.float32, N=DIST_S)
    torch.cuda.empty_cache()


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


def _param_errors(params: dict, ref: dict) -> dict:
    """Gathered parameters against one process's: the count, whether the
    keys agree, the worst ``(name, max |difference|)`` apart from the
    key bias (``qkv_bias[1]``), and the key bias's own worst."""
    import numpy as np
    rest, key_bias = {}, {}
    for k, v in ref.items():
        d = np.abs(params[k] - v)
        if k.endswith("qkv_bias"):
            key_bias[k] = float(d[1].max())
            d = np.delete(d, 1, axis=0)
        rest[k] = float(d.max())
    return {"n_params": len(rest), "keys_equal": set(params) == set(ref),
            "worst": max(rest.items(), key=lambda kv: kv[1]),
            "key_bias": max(key_bias.values())}


def _dist_parity(ref_path: str, rank: int, dp: int, mp: int) -> dict:
    import gc
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
        out.update(_param_errors(params, ref["params"]))
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
            comm.append(sum(_comm_by_op(reg).values()))
        by_op = _comm_by_op(reg)
    out = {"losses": losses, "times": times, "by_op": by_op,
           "comm": [b - a for a, b in zip([0.0] + comm, comm)],
           "peak": torch.cuda.max_memory_allocated(),
           "updates": step.step_count, "microsteps": step._micro_count}
    fleet.reset()
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (e)-(g): the pipeline over the same four ranks. (f) f32 parity at
# gpt2_medium widths x 4 layers, a global batch of 4 in 4 microbatches,
# dropout 0.1, two steps, at pp = 2 x mp = 2 and pp = 4 under both
# schedules, against one process's step; (g) BASELINE config 4's model:
# gpt2_medium at pp = 2 x mp = 2, 8 microbatches of one row, O1,
# ``pretraining_loss`` under 1F1B, then config 4's own loss style,
# ``crit(layer(ids), labels)`` (the fill-drain forward, the last stage's
# logits broadcast over pp)
PIPE_PARITY_LAYERS, PIPE_PARITY_M = 4, 4
PIPE_LAYOUTS = {"pp=2 x mp=2": (2, 2), "pp=4": (4, 1)}
# two timed updates each (four and three until phase 24 needed the
# script's time)
PIPE_B, PIPE_M, PIPE_UPDATES, PIPE_FWD_UPDATES = 8, 8, 2, 2
GLOO_RAW_OPS = ("send_recv", "isend_irecv", "batch_isend_irecv")


def _gloo_raw_rank(rank: int, port: int, op: str, out: str) -> None:
    """One rank of a two-process gloo world that hands ``op`` a CUDA
    tensor as it is, with no staging (a subprocess of its own: gloo
    aborts a sender it gives a device pointer)."""
    import json
    import torch
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=2)
    x = torch.arange(6, dtype=torch.float32, device="cuda") + 10 * rank
    y = torch.zeros(6, device="cuda")
    peer = 1 - rank
    res = {}
    try:
        if op == "send_recv":
            if rank == 0:
                dist.send(x, 1, tag=3)
            else:
                dist.recv(y, 0, tag=3)
        elif op == "isend_irecv":
            w = (dist.isend(x, 1, tag=5) if rank == 0
                 else dist.irecv(y, 0, tag=5))
            w.wait()
        else:
            for w in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, x, peer),
                     dist.P2POp(dist.irecv, y, peer)]):
                w.wait()
        torch.cuda.synchronize()
        want = (torch.arange(6.0) + 10 * peer if op == "batch_isend_irecv"
                else torch.arange(6.0))
        res["ok"] = rank == 0 and op != "batch_isend_irecv" or bool(
            torch.equal(y.cpu(), want))
    except Exception as e:
        res["error"] = f"{type(e).__name__}: {str(e)[:160]}"
    with open(out, "w") as f:
        json.dump(res, f)


def _gloo_raw_start(tmp: str) -> list:
    """(e) first half: what gloo itself does with CUDA tensors, one pair
    of processes a point-to-point op, all started at once (run beside
    the world's start-up)."""
    import subprocess
    procs = []
    for i, op in enumerate(GLOO_RAW_OPS):
        port = 29700 + i
        for r in range(2):
            out = os.path.join(tmp, f"gloo_{op}_{r}.json")
            code = (f"import sys; sys.path.insert(0, {REPO!r}); import "
                    f"chip_smoke; chip_smoke._gloo_raw_rank({r}, {port}, "
                    f"{op!r}, {out!r})")
            procs.append((op, r, out, subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE)))
    return procs


def _gloo_raw_finish(procs) -> dict:
    """Wait for the raw pairs (60 s at most, then killed): per op, each
    rank's exit code and what it reported."""
    import json
    import subprocess
    out = {}
    for op, r, path, p in procs:
        try:
            _, err = p.communicate(timeout=60)
            rc = p.returncode
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            rc = "timeout"
        res = {}
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        tail = err.decode(errors="replace").strip().splitlines()
        if rc != 0 and tail:
            res.setdefault("error", tail[-1][:160])
        out.setdefault(op, []).append((rc, res))
    return out


def _pipe_p2p(rank: int) -> dict:
    """(e) second half, in the world: the port's isend / recv (two tags
    received in the other order), isend / irecv and ppermute_shift on
    CUDA tensors over gloo, their values and route; the time of a 2 MB
    bf16 handoff (one microbatch's [1, 1024, 1024] boundary at O1)."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective
    peer = rank ^ 1
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 100 * rank
    ok = {}
    if rank % 2 == 0:
        # a gloo send completes once its receiver posts the receive:
        # post both, then wait
        for w in [collective.isend(x, peer, tag=1),
                  collective.isend(x * 2, peer, tag=2)]:
            w.wait()
    else:
        a, b = torch.zeros_like(x), torch.zeros_like(x)
        dist.recv(b, peer, tag=2)
        dist.recv(a, peer, tag=1)
        want = torch.arange(8.0, device="cuda") + 100 * peer
        ok["send_recv"] = bool(torch.equal(a, want)
                               and torch.equal(b, want * 2))
    y = torch.zeros_like(x)
    w_s = collective.isend(x, peer, tag=7)
    w_r = collective.irecv(y, peer, tag=7)
    w_s.wait()
    w_r.wait()
    ok["isend_irecv"] = bool(torch.equal(
        y, torch.arange(8.0, device="cuda") + 100 * peer))
    z = dist.ppermute_shift(x, shift=1)
    ok["ppermute_shift"] = bool(torch.equal(
        z, torch.arange(8.0, device="cuda") + 100 * ((rank - 1) % 4)))
    h = (torch.arange(1024 * 1024, device="cuda") % 251).reshape(
        1, 1024, 1024).to(torch.bfloat16)
    got = torch.empty_like(h)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        if rank % 2 == 0:
            collective.isend(h, peer, tag=100 + i).wait()
        else:
            dist.recv(got, peer, tag=100 + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 100.0
    if rank % 2:
        ok["handoff_values"] = bool(torch.equal(got, h))
    return {"ok": ok, "route": collective.p2p_route(h), "handoff_ms": ms}


def _pipe_model(layers: int, M: int, **cfg_kw):
    from paddle_tpu_torch.models import GPTForPretrainingPipe, gpt2_medium
    return GPTForPretrainingPipe(gpt2_medium(num_layers=layers, **cfg_kw),
                                 num_microbatches=M, device="cuda", seed=0)


def _pipe_reference(w_path: str, ref_path: str) -> list:
    """(f)'s reference: one process's f32 GPTForPretraining step (seed 0,
    dropout 0.1) on the pipe model's weights (saved to ``w_path`` under
    its stacked names), the same batch and seed; losses and parameters
    (restacked) to ``ref_path``."""
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch.framework.io import save, to_numpy
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium)
    from paddle_tpu_torch.optimizer import AdamW

    def stacked(model):
        out, blocks = {}, {}
        for k, v in model.state_dict().items():
            name = k[len("gpt."):]
            if name.startswith("layers."):
                _, i, rest = name.split(".", 2)
                blocks.setdefault("blocks.stacked__" + rest.replace(
                    ".", "__"), []).append(to_numpy(v))
            else:
                out[name] = to_numpy(v)
        out.update({k: np.stack(v) for k, v in blocks.items()})
        return out
    model = GPTForPretraining(gpt2_medium(num_layers=PIPE_PARITY_LAYERS),
                              device="cuda", seed=0)
    save(stacked(model), w_path)
    crit = GPTPretrainingCriterion()
    step = TrainStep(model, lambda layer, i, t: crit(layer(i), t), AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0)
    ids, labels = _dist_batch(PIPE_PARITY_M, DIST_S, 7)
    losses = [float(step(ids, labels)) for _ in range(DIST_PARITY_STEPS)]
    save({"losses": losses, "params": stacked(model)}, ref_path)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _pipe_step(pp: int, mp: int, model, loss_fn, schedule: str):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": pp,
                               "mp_degree": mp}
    strategy.pipeline_configs = {"schedule_mode": schedule}
    fleet.init(strategy=strategy, backend="gloo")
    hcg = fleet.get_hybrid_communicate_group()
    model = fleet.distributed_model(model)
    return hcg, TrainStep(model, loss_fn, AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0, mesh=hcg.mesh, data_spec=P("dp"), zero_axis="dp")


def _pipe_parity(w_path: str, ref_path: str, rank: int) -> dict:
    """(f) on this rank: each layout and schedule, two f32 steps of
    ``pretraining_loss`` on the reference's weights and batch; rank 0
    holds the gathered parameters against the reference and the two
    schedules against each other, bit for bit."""
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import spmd_pipeline
    from paddle_tpu_torch.framework.io import load
    from paddle_tpu_torch.models import gather_state_dict, load_jax_weights
    weights = load(w_path)
    ids, labels = _dist_batch(PIPE_PARITY_M, DIST_S, 7)
    ref = load(ref_path) if rank == 0 else None
    out = {}
    for name, (pp, mp) in PIPE_LAYOUTS.items():
        kept = None
        for sched in ("fill_drain", "1f1b"):
            spmd_pipeline.reset_pipeline_stats()
            model = _pipe_model(PIPE_PARITY_LAYERS, PIPE_PARITY_M)
            hcg, step = _pipe_step(
                pp, mp, model,
                lambda layer, i, t: layer.pretraining_loss(i, t), sched)
            load_jax_weights(step.layer, weights)
            t0 = time.perf_counter()
            losses = [float(step(ids, labels))
                      for _ in range(DIST_PARITY_STEPS)]
            secs = time.perf_counter() - t0
            params = gather_state_dict(step.layer, hcg.mesh)
            res = {"losses": losses, "seconds": secs,
                   "stage": hcg.get_stage_id(),
                   "in_flight": spmd_pipeline.PIPELINE_STATS[
                       "max_in_flight"]}
            if rank == 0:
                rest, key_bias = {}, 0.0
                for k, v in ref["params"].items():
                    d = np.abs(params[k] - v)
                    if k.endswith("qkv_bias"):
                        key_bias = max(key_bias, float(d[:, 1].max()))
                        d = np.delete(d, 1, axis=1)
                    rest[k] = float(d.max())
                res.update(ref_losses=ref["losses"],
                           keys_equal=set(params) == set(ref["params"]),
                           worst=max(rest.items(), key=lambda kv: kv[1]),
                           key_bias=key_bias)
                if kept is None:
                    kept = (losses, params)
                else:
                    res["bit_equal"] = losses == kept[0] and all(
                        np.array_equal(v, kept[1][k])
                        for k, v in params.items())
            out[(name, sched)] = res
            fleet.reset()
            del step, model, params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _pipe_timed(rank: int, forward_style: bool = False) -> dict:
    """(g) on this rank: BASELINE config 4's model under
    ``auto_cast(level="O1")``, ``pretraining_loss`` under 1F1B for
    ``PIPE_UPDATES`` updates or, with ``forward_style``, config 4's
    ``crit(layer(ids), labels)`` for ``PIPE_FWD_UPDATES``, on one batch;
    update times, the comm_* seconds by op and group, the peak memory,
    the in-flight maximum."""
    import gc
    import torch
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import spmd_pipeline
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.monitor import scoped_registry
    torch.cuda.reset_peak_memory_stats()
    spmd_pipeline.reset_pipeline_stats()
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        with auto_cast(level="O1"):
            if forward_style:
                return crit(layer(ids), labels)
            return layer.pretraining_loss(ids, labels)
    hcg, step = _pipe_step(2, 2, _pipe_model(24, PIPE_M), loss_fn, "1F1B")
    ids, labels = _dist_batch(PIPE_B, DIST_S, 30)
    losses, times = [], []
    with scoped_registry() as reg:
        for _ in range(PIPE_FWD_UPDATES if forward_style else PIPE_UPDATES):
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels)))
            times.append(time.perf_counter() - t0)
        by_op = _comm_by_op(reg)
    out = {"losses": losses, "times": times, "by_op": by_op,
           "peak": torch.cuda.max_memory_allocated(),
           "stage": hcg.get_stage_id(), "updates": step.step_count,
           "in_flight": spmd_pipeline.PIPELINE_STATS["max_in_flight"],
           "handoffs": (spmd_pipeline.PIPELINE_STATS["sent"],
                        spmd_pipeline.PIPELINE_STATS["received"])}
    fleet.reset()
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipe_want(stage: int, S: int, mp: int, layers: int, M: int,
               steps: int) -> dict:
    """One rank's launches in ``steps`` pipelined steps on stage
    ``stage`` of ``S`` (``layers / S`` layers, ``M`` microbatches, the
    stage's layers recomputed as one segment, dropout on): each
    microbatch runs row 1 once a layer in its forward and once in the
    recompute, row 3 once; the hidden dropouts twice a layer forward,
    twice backward and, in the recompute, all but the last layer's
    second (``torch.utils.checkpoint``'s early stop), so 6 * L/S - 1;
    the embedding dropout's two on the first stage; at mp = 1 the
    chunked CE's two kernels once a microbatch on the last stage (the
    vocab-parallel loss is dense at mp = 2)."""
    ll = layers // S
    ce = M if (mp == 1 and stage == S - 1) else 0
    return dict(_zero_launches(), flash_attention_fwd=2 * ll * M * steps,
                flash_attention_bwd=ll * M * steps,
                fused_dropout=((6 * ll - 1) * M
                               + (2 if stage == 0 else 0)) * steps,
                chunked_ce_lse=ce * steps, chunked_ce_dlogits=ce * steps)


# (h) sequence parallelism over the same four ranks: ring and Ulysses
# attention at sp = 4 on [2, 4096, 16, 64] bf16, causal, dropout 0.1,
# against one process's rows 1 and 3 on the whole sequence; f32 parity of
# a sequence-parallel GPT (gpt2_medium widths x 2 layers, B = 2, S =
# 1024, dropout 0.1, two steps) at sp = 2 x mp = 2 and sp = 4 against one
# process's step
SP_B, SP_S, SP_H, SP_D, SP_RANKS = 2, 4096, 16, 64, 4
SP_LAYOUTS = {"sp=2 x mp=2": (2, 2), "sp=4": (4, 1)}
SP_PARITY_LAYERS, SP_PARITY_B, SP_PARITY_STEPS = 2, 2, 2
# a ring block's o merges in f32 and rounds once; its dq (and each
# block's dk, dv) sums the blocks' bf16 kernel outputs in f32, one bf16
# rounding a block, so the gradients get a few bf16 ulps more than o
SP_ATTN_TOL = {"o": 2.0 ** -7, "grads": 2.0 ** -6}
# (i) BASELINE config 5: ERNIE-3.0 1.5B at sharding = 2 x mp = 2 (dp cut
# from n/4 to 1 for one card), O1, AdamW, ZeRO over sharding; a global
# batch of 8 (4 a sharding rank), S = 512, 76 masked positions a row, the
# last row padded from position 384; one warm-up, then two updates
E5_SHARDING, E5_MP, E5_B, E5_S, E5_M = 2, 2, 8, 512, 76
# two timed updates (three until phase 24 needed the script's time)
E5_PAD_FROM, E5_UPDATES, E5_LR, E5_WD = 384, 2, 1e-4, 0.01
# the peak lr is reached by a linear warmup over E5_WARMUP updates, as
# ERNIE's pretraining recipe warms up: at 1e-4 from the first update
# Adam's first sign-like steps move every weight of the 24 post-LN
# layers coherently and the loss rose 12.12 -> 13.64 -> 27.92 -> 23.96
# over the warm-up call and three updates (H100 80GB HBM3, 700.00 W;
# PERF.md, PR 17), as ERNIE-base's jumps at its second step at 1e-4 in
# both packages
E5_WARMUP = 10
# (j) resharding: config 5's widths at 2 layers, f32, dropout 0.1: two
# steps at sharding = 2 x mp = 2, a sharded save, two more; resumed at
# the same layout (bit-exact), at mp = 4 and in one process (each within
# RESHARD_TOL of the uninterrupted run's losses, relative)
RESHARD_LAYERS, RESHARD_STEPS, RESHARD_TOL = 2, 2, 1e-5


def _e5_batch(seed: int):
    """Config 5's batch: BERT-style records at ERNIE's vocab, the last row
    padded from ``E5_PAD_FROM``; ``(ids, token types, mask, positions,
    labels, weights, sop)``."""
    lengths = [E5_S] * (E5_B - 1) + [E5_PAD_FROM]
    fields, sop = pretraining_batch(E5_B, E5_S, E5_M, 40000, seed=seed,
                                    lengths=lengths)
    return fields + (sop,)


def _ernie_loss(amp: bool):
    from paddle_tpu_torch.amp import auto_cast

    def loss_fn(layer, ids, tt, am, pos, lab, w, sop):
        with (auto_cast(level="O1") if amp else contextlib.nullcontext()):
            mlm, s = layer(ids, tt, am, pos)
            return layer.loss(mlm, s, lab, sop, w)
    return loss_fn


def _ernie_step(hybrid, cfg, seed: int, amp: bool, lr: float,
                built=None):
    """An ERNIE ``TrainStep``: over ``hybrid`` (fleet's hybrid configs)
    built with ``mesh=`` (each rank's blocks only) and laid out by
    ``apply_hybrid_specs``, ZeRO over sharding; without, one process.
    ``built`` (a dict) gets the model's build seconds and the device
    memory peak up to then (before the optimizer's slots)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P, apply_hybrid_specs
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    mesh = None
    if hybrid is not None:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = dict(hybrid)
        fleet.init(strategy=strategy, backend="gloo")
        mesh = fleet.get_hybrid_communicate_group().mesh
    t0 = time.perf_counter()
    model = ErnieForPretraining(cfg, device="cuda", seed=seed, mesh=mesh)
    if built is not None:
        import torch
        torch.cuda.synchronize()
        built.update(seconds=time.perf_counter() - t0,
                     peak=torch.cuda.max_memory_allocated(),
                     blocks=sum(p.numel() * p.element_size()
                                for p in model.parameters()))
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=E5_WD)
    if mesh is None:
        return TrainStep(model, _ernie_loss(amp), opt, seed=0)
    apply_hybrid_specs(model)
    return TrainStep(model, _ernie_loss(amp), opt, seed=0, mesh=mesh,
                     data_spec=P(("dp", "sharding")), zero_axis="sharding")


def _sp_attention(rank: int) -> dict:
    """(h) ring and Ulysses attention at sp = 4 against one process's
    rows 1 and 3 on the whole sequence (every rank runs the whole launch
    too, from the same seeded inputs); one counted call of each, then
    the median of three timed calls of each and of the whole launch."""
    import gc
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sp_degree": SP_RANKS}
    fleet.init(strategy=strategy, backend="gloo")
    group = fleet.get_hybrid_communicate_group() \
        .get_sequence_parallel_group()
    rate, words = 0.1, (0x31415926, 0x27182818)
    g = torch.Generator(device="cuda").manual_seed(41)
    q, k, v, do = (torch.randn(SP_B, SP_S, SP_H, SP_D, device="cuda",
                               generator=g).to(torch.bfloat16)
                   for _ in range(4))

    def whole():
        o, lse = flash_attention_fwd(q, k, v, True, None, True, rate, words)
        return (o,) + flash_attention_bwd(q, k, v, o, lse, do, True, None,
                                          rate, words)
    ref = whole()
    n = SP_S // SP_RANKS
    sl = slice(rank * n, (rank + 1) * n)
    shards = [t[:, sl].contiguous() for t in (q, k, v, do)]

    def call(fn):
        qs, ks, vs = (t.clone().requires_grad_() for t in shards[:3])
        o = fn(qs, ks, vs, group, causal=True, dropout_rate=rate,
               seed_words=words)
        o.backward(shards[3])
        return o.detach(), qs.grad, ks.grad, vs.grad
    out = {}
    kernels.reset_launch_counts()
    got = {name: call(fn) for name, fn in
           (("ring", ra.ring_attention), ("ulysses", ra.ulysses_attention))}
    out["launches"] = {k_["name"]: k_["launches"]
                       for k_ in kernels.kernels()}
    for name, res in got.items():
        errs = [_rel_err(a, w[:, sl]) for a, w in zip(res, ref)]
        out[name] = {"errs": errs}

    def timed(fn):
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            ra.reset_ring_stats()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0,
                       ra.RING_STATS["hop_s"] + ra.RING_STATS["alltoall_s"],
                       ra.RING_STATS["hops"] + ra.RING_STATS["alltoalls"]))
        ts = sorted(ts[1:])
        return ts[len(ts) // 2]
    for name, fn in (("ring", ra.ring_attention),
                     ("ulysses", ra.ulysses_attention)):
        out[name]["time"] = timed(lambda fn=fn: call(fn))
    out["whole"] = timed(whole)
    fleet.reset()
    del q, k, v, do, ref, got, shards
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sp_model(amp=False):
    return _dist_model(SP_PARITY_LAYERS, amp, sequence_parallel=True)


def _sp_reference(path: str) -> list:
    """(h)'s reference: one process's float32 step of the sequence-parallel
    GPT's config (no sp axis, so the whole sequence) on the same weights,
    batch and seed; its losses and parameters to ``path``."""
    import gc
    import torch
    from paddle_tpu_torch.framework.io import save
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    model, loss_fn = _sp_model()
    step = TrainStep(model, loss_fn, AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0)
    ids, labels = _dist_batch(SP_PARITY_B, DIST_S, 7)
    losses = [float(step(ids, labels)) for _ in range(SP_PARITY_STEPS)]
    save({"losses": losses, "params": step.state_dict()["params"]}, path)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _sp_parity(ref_path: str, rank: int, sp: int, mp: int) -> dict:
    """(h) the sequence-parallel GPT at ``sp`` x ``mp`` against one
    process: losses, and on rank 0 the gathered parameters' worst
    difference (the key bias apart, as (c))."""
    import gc
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.framework.io import load
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.optimizer import AdamW
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sp_degree": sp, "mp_degree": mp}
    fleet.init(strategy=strategy, backend="gloo")
    mesh = fleet.get_hybrid_communicate_group().mesh
    model, loss_fn = _sp_model()
    step = TrainStep(model, loss_fn, AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0, mesh=mesh, data_spec=P("dp"))
    ids, labels = _dist_batch(SP_PARITY_B, DIST_S, 7)
    ra.reset_ring_stats()
    t0 = time.perf_counter()
    losses = [float(step(ids, labels)) for _ in range(SP_PARITY_STEPS)]
    out = {"losses": losses, "seconds": time.perf_counter() - t0,
           "hop_s": ra.RING_STATS["hop_s"], "hops": ra.RING_STATS["hops"]}
    params = step.state_dict()["params"]
    if rank == 0:
        ref = load(ref_path)
        out["ref_losses"] = ref["losses"]
        out.update(_param_errors(params, ref["params"]))
    fleet.reset()
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sp_want(rank: int, sp: int, mp: int) -> dict:
    """One rank's launches in (h)'s parity run: causal ring attention
    visits the blocks of sp ranks at or before its own (``sp_rank + 1``
    row 1 and row 3 launches a layer a step); the hidden dropouts once
    each forward and backward (the embedding's and two a layer); at mp =
    1 the chunked CE's two kernels once a step."""
    L, n = SP_PARITY_LAYERS, SP_PARITY_STEPS
    blocks = rank // mp % sp + 1
    ce = n if mp == 1 else 0
    return dict(_zero_launches(), flash_attention_fwd=blocks * L * n,
                flash_attention_bwd=blocks * L * n,
                fused_dropout=2 * (1 + 2 * L) * n, chunked_ce_lse=ce,
                chunked_ce_dlogits=ce)


def _zero_launches() -> dict:
    from paddle_tpu_torch.ops import kernels
    return {k["name"]: 0 for k in kernels.kernels()}


def _ernie_hybrid(rank: int) -> dict:
    """(i) BASELINE config 5's model at sharding = 2 x mp = 2: the
    rank's blocks, the build's peak, one warm-up, then ``E5_UPDATES``
    timed updates with their launches, the collective split and the
    peak."""
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ernie_3_1p5b
    from paddle_tpu_torch.monitor import scoped_registry
    from paddle_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    built = {}
    step = _ernie_step({"sharding_degree": E5_SHARDING,
                        "mp_degree": E5_MP}, ernie_3_1p5b(), 0, True, E5_LR,
                       built)
    layer = step.layer
    enc = layer.ernie.encoder.layers[0]
    shapes = {n: tuple(p.shape) for n, p in (
        ("q_proj", enc.self_attn.q_proj.weight),
        ("out_proj", enc.self_attn.out_proj.weight),
        ("linear1", enc.linear1.weight), ("linear2", enc.linear2.weight),
        ("word_embeddings", layer.ernie.embeddings.word_embeddings.weight),
        ("decoder_bias", layer.decoder_bias))}
    n_local = sum(p.numel() for p in layer.parameters())
    batch = _e5_batch(15)

    def update():
        step.optimizer.set_lr(E5_LR * min(1.0, (step.step_count + 1)
                                          / E5_WARMUP))
        return float(step(*batch))
    t0 = time.perf_counter()
    warm = update()
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    losses, times, comm = [], [], []
    with scoped_registry() as reg:
        for _ in range(E5_UPDATES):
            t0 = time.perf_counter()
            losses.append(update())
            times.append(time.perf_counter() - t0)
            comm.append(sum(_comm_by_op(reg).values()))
        by_op = _comm_by_op(reg)
    out = {"warm": warm, "losses": losses, "times": times, "by_op": by_op,
           "comm": [b - a for a, b in zip([0.0] + comm, comm)],
           "launches": {k["name"]: k["launches"]
                        for k in kernels.kernels()},
           "shapes": shapes, "n_local": n_local, "built": built,
           "warm_s": warm_s,
           "peak": torch.cuda.max_memory_allocated(),
           "finite": bool(np.isfinite([warm] + losses).all())}
    fleet.reset()
    del step, layer, enc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _e5_want() -> dict:
    """One rank's launches in (i)'s timed updates: the biased forward, dq
    and dk/dv/dbias once a layer an update; the fused dropout on the
    embeddings' output and twice a layer, forward and backward; the
    vocab-parallel loss is dense (no chunked CE)."""
    L, n = 24, E5_UPDATES
    return dict(_zero_launches(), flash_attention_bias_fwd=L * n,
                flash_attention_bias_bwd_dq=L * n,
                flash_attention_bias_bwd_dkv=L * n,
                fused_dropout=2 * (1 + 2 * L) * n)


def _states_equal(a, b) -> bool:
    """Every parameter and optimizer slot of two steps bit-equal."""
    import torch
    pa = list(a.layer.parameters())
    pb = list(b.layer.parameters())
    sa = [s for p in pa for s in a.optimizer._accumulators.get(id(p), ())]
    sb = [s for p in pb for s in b.optimizer._accumulators.get(id(p), ())]
    return len(pa) == len(pb) and len(sa) == len(sb) and all(
        torch.equal(x, y) for x, y in zip(pa + sa, pb + sb))


def _reshard(rank: int, tmp: str) -> dict:
    """(j) a sharded save at sharding = 2 x mp = 2 after two steps; two
    more (the uninterrupted run); resumed from the checkpoint at the same
    layout (losses, parameters and slots bit-equal), at mp = 4 and, on
    rank 0 alone, in one process."""
    import gc
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ernie_3_1p5b
    cfg = ernie_3_1p5b(num_layers=RESHARD_LAYERS)
    hybrid = {"sharding_degree": E5_SHARDING, "mp_degree": E5_MP}
    batch = _e5_batch(16)
    path = os.path.join(tmp, "reshard", "step_2")
    a = _ernie_step(hybrid, cfg, 0, False, E5_LR)
    first = [float(a(*batch)) for _ in range(RESHARD_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_train_step(a, path, asynchronous=False)
    save_s = time.perf_counter() - t0
    ref = [float(a(*batch)) for _ in range(RESHARD_STEPS)]
    out = {"first": first, "ref": ref, "save_s": save_s}
    if rank == 0:
        m = ckpt.read_manifest(path)
        out["bytes"] = sum(e["size"] for e in m["files"].values())
        out["files"] = sorted(m["files"])
        out["spec"] = m["leaves"][
            "['params']['ernie.encoder.layers.0.self_attn.q_proj.weight']"]
        out["valid"] = ckpt.verify_checkpoint(path, level="full")
    fleet.reset()
    for tag, layout, seed in (("same", hybrid, 1),
                              ("mp=4", {"mp_degree": 4}, 2)):
        b = _ernie_step(layout, cfg, seed, False, E5_LR)
        t0 = time.perf_counter()
        ckpt.load_train_step(b, path)
        load_s = time.perf_counter() - t0
        out[tag] = {"losses": [float(b(*batch))
                               for _ in range(RESHARD_STEPS)],
                    "load_s": load_s, "step_count": b.step_count}
        if tag == "same":
            out[tag]["state_equal"] = _states_equal(a, b)
            del a
        fleet.reset()
        del b
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        c = _ernie_step(None, cfg, 3, False, E5_LR)
        t0 = time.perf_counter()
        ckpt.load_train_step(c, path)
        out["one"] = {"load_s": time.perf_counter() - t0,
                      "losses": [float(c(*batch))
                                 for _ in range(RESHARD_STEPS)]}
        del c
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
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
    res["p2p"] = _pipe_p2p(rank)
    kernels.reset_launch_counts()
    res["pipe_parity"] = _pipe_parity(
        os.path.join(out_dir, "pipe_weights.pdparams"),
        os.path.join(out_dir, "pipe_reference.pdparams"), rank)
    res["launches_pipe_parity"] = launches()
    kernels.reset_launch_counts()
    res["pipe"] = _pipe_timed(rank)
    res["launches_pipe"] = launches()
    kernels.reset_launch_counts()
    res["pipe_forward"] = _pipe_timed(rank, forward_style=True)
    res["launches_pipe_forward"] = launches()
    secs = {}
    t = time.perf_counter()
    res["sp_attention"] = _sp_attention(rank)
    res["sp_parity"], res["launches_sp_parity"] = {}, {}
    for tag, (sp, mp) in SP_LAYOUTS.items():
        kernels.reset_launch_counts()
        res["sp_parity"][tag] = _sp_parity(
            os.path.join(out_dir, "sp_reference.pdparams"), rank, sp, mp)
        res["launches_sp_parity"][tag] = launches()
    secs["h"] = time.perf_counter() - t
    t = time.perf_counter()
    res["ernie"] = _ernie_hybrid(rank)
    secs["i"] = time.perf_counter() - t
    t = time.perf_counter()
    res["reshard"] = _reshard(rank, out_dir)
    secs["j"] = time.perf_counter() - t
    res["seconds"] = secs
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
    zero = _zero_launches()
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
    O1 run; the pipeline: (e) the point-to-point probe (gloo's own ops
    on CUDA tensors in pairs of processes of their own, beside the
    world; the port's in it), (f) float32 parity at pp x mp and pp = 4
    under both schedules against one process, (g) BASELINE config 4
    timed under 1F1B and in config 4's own loss style. Returns the
    launches of (d), (c), (g) under 1F1B, (g) in config 4's loss style and
    (f), each summed over the ranks."""
    import pickle
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed.spawn_mod import spawn
    t = time.perf_counter()
    _dist_offsets()
    _pipe_kernel_shapes()
    _dist_nccl()
    _log(f"distributed: (a) and (b) took {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ref = _dist_reference(os.path.join(tmp, "reference.pdparams"))
        _log(f"distributed: the one-process reference, losses "
             + " ".join(f"{x:.6f}" for x in ref)
             + f" ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        pipe_ref = _pipe_reference(
            os.path.join(tmp, "pipe_weights.pdparams"),
            os.path.join(tmp, "pipe_reference.pdparams"))
        _log(f"distributed: (f)'s one-process reference, gpt2_medium widths "
             f"x {PIPE_PARITY_LAYERS} layers, f32, dropout 0.1, B="
             f"{PIPE_PARITY_M} S={DIST_S}: losses "
             + " ".join(f"{x:.6f}" for x in pipe_ref)
             + f" ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        sp_ref = _sp_reference(os.path.join(tmp, "sp_reference.pdparams"))
        _log(f"distributed: (h)'s one-process reference, the "
             f"sequence-parallel GPT's config (gpt2_medium widths x "
             f"{SP_PARITY_LAYERS} layers, f32, dropout 0.1, B={SP_PARITY_B} "
             f"S={DIST_S}): losses " + " ".join(f"{x:.6f}" for x in sp_ref)
             + f" ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        raw = _gloo_raw_start(tmp)
        spawn("chip_smoke:_dist_rank", args=(tmp,), nprocs=DIST_RANKS)
        _log(f"distributed: the {DIST_RANKS}-rank world took "
             f"{time.perf_counter() - t:.1f} s (start, parity, timed run, "
             "the pipeline's probe, parity and timed run)")
        raw = _gloo_raw_finish(raw)
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
    # every part prints its readings before the first failed check
    # raises
    failed = []
    for report in (lambda: _pipe_report(ranks, raw, smi),
                   lambda: _sp_report(ranks, smi),
                   lambda: _ernie_report(ranks, smi),
                   lambda: _reshard_report(ranks)):
        try:
            report()
        except RuntimeError as e:
            failed.append(e)
    if failed:
        raise failed[0]
    from paddle_tpu_torch.ops import kernels
    names = [k["name"] for k in kernels.kernels()]

    def total(pick):
        return {n: sum(pick(r)[n] for r in ranks) for n in names}
    paths = {path: total(lambda r, key=key: r[key]) for path, key in (
        ("dist", "launches"), ("dist_parity", "launches_parity"),
        ("pipe", "launches_pipe"), ("pipe_forward", "launches_pipe_forward"),
        ("pipe_parity", "launches_pipe_parity"))}
    paths["sp_parity"] = {n: sum(r["launches_sp_parity"][tag][n]
                                 for r in ranks for tag in SP_LAYOUTS)
                          for n in names}
    paths["ring"] = total(lambda r: r["sp_attention"]["launches"])
    paths["ernie_hybrid"] = total(lambda r: r["ernie"]["launches"])
    return paths


def _sp_report(ranks, smi: str) -> None:
    """Phase 21's (h): check and print."""
    import numpy as np
    tol = SP_ATTN_TOL
    for name in ("ring", "ulysses"):
        errs = np.max([r["sp_attention"][name]["errs"] for r in ranks], 0)
        tm = [r["sp_attention"][name]["time"] for r in ranks]
        _log(f"distributed: (h) {name} attention over sp = {SP_RANKS} on "
             f"[{SP_B}, {SP_S}, {SP_H}, {SP_D}] bf16, causal, dropout 0.1, "
             f"against one process's rows 1 and 3 on the whole sequence: "
             f"o {errs[0]:.3e} (tol {tol['o']:g}), dq {errs[1]:.3e}, dk "
             f"{errs[2]:.3e}, dv {errs[3]:.3e} (tol {tol['grads']:g}); "
             "forward and backward by rank " + ", ".join(
                 f"{t[0] * 1e3:.1f} ms ({100 * t[1] / t[0]:.1f}% in {t[2]} "
                 f"{'hops' if name == 'ring' else 'all-to-alls'})"
                 for t in tm) + f" ({smi})")
        _require(errs[0] <= tol["o"] and max(errs[1:]) <= tol["grads"],
                 f"(h) {name} attention differs from one process's: {errs}")
    whole = [r["sp_attention"]["whole"][0] for r in ranks]
    _log(f"distributed: (h) one process's rows 1 and 3 on the whole "
         f"[{SP_B}, {SP_S}, {SP_H}, {SP_D}] (each rank, while the others "
         f"ran theirs): " + ", ".join(f"{t * 1e3:.1f} ms" for t in whole))
    for r, res in enumerate(ranks):
        la = res["sp_attention"]["launches"]
        me = r % SP_RANKS
        want = dict(_zero_launches(), flash_attention_fwd=me + 2,
                    flash_attention_bwd=me + 2)
        _require(la == want, f"rank {r}: (h) ring + Ulysses launches {la} "
                 f"!= {want}")
    for tag, (sp, mp) in SP_LAYOUTS.items():
        p0 = ranks[0]["sp_parity"][tag]
        rel = max(abs(a - b) / abs(b) for r in ranks
                  for a, b in zip(r["sp_parity"][tag]["losses"],
                                  p0["ref_losses"]))
        hop = max(r["sp_parity"][tag]["hop_s"] / r["sp_parity"][tag][
            "seconds"] for r in ranks)
        _log(f"distributed: (h) sequence-parallel GPT at {tag}, f32, "
             f"dropout 0.1, gpt2_medium widths x {SP_PARITY_LAYERS} layers, "
             f"B={SP_PARITY_B} S={DIST_S}: losses " + " ".join(
                 f"{x:.6f}" for x in p0["losses"]) + " against one "
             f"process's, largest relative difference {rel:.3e} (tol "
             f"{DIST_LOSS_TOL:g}); gathered parameters worst "
             f"{p0['worst'][0]} {p0['worst'][1]:.3e} (tol "
             f"{DIST_PARAM_TOL:g}), the key bias {p0['key_bias']:.3e} (tol "
             f"{DIST_KEY_BIAS_TOL:g}); {p0['seconds']:.2f} s for "
             f"{SP_PARITY_STEPS} steps, {p0['hops']} ring hops a rank, up "
             f"to {100 * hop:.1f}% of the run in them")
        _require(p0["keys_equal"], f"(h) {tag}: the gathered keys")
        _require(rel <= DIST_LOSS_TOL, f"(h) {tag}: losses differ by {rel}")
        _require(p0["worst"][1] <= DIST_PARAM_TOL
                 and p0["key_bias"] <= DIST_KEY_BIAS_TOL,
                 f"(h) {tag}: parameters differ: {p0['worst']}, key bias "
                 f"{p0['key_bias']}")
        for r, res in enumerate(ranks):
            want = _sp_want(r, sp, mp)
            got = res["launches_sp_parity"][tag]
            _require(got == want, f"rank {r}: (h) {tag} launches {got} != "
                     f"{want}")
    _log("distributed: (h) launches a rank, each exactly the formula: "
         + "; ".join(f"{tag} {ranks[0]['launches_sp_parity'][tag]}"
                     for tag in SP_LAYOUTS))


def _ernie_report(ranks, smi: str) -> None:
    """Phase 21's (i): check and print."""
    import numpy as np
    res = [r["ernie"] for r in ranks]
    e0 = res[0]
    want_shapes = {"q_proj": (2048, 1024), "out_proj": (1024, 2048),
                   "linear1": (2048, 4096), "linear2": (4096, 2048),
                   "word_embeddings": (20000, 2048), "decoder_bias": (40000,)}
    curve = [e0["warm"]] + e0["losses"]
    want = _e5_want()
    step_s = float(np.median(e0["times"]))
    tokens = E5_B * E5_S
    comm = [float(np.median([c / w for c, w in zip(e["comm"], e["times"])]))
            for e in res]
    _log(f"distributed: (i) BASELINE config 5, ERNIE-3.0 1.5B (24 layers, "
         f"hidden 2048, 16 heads, FFN 8192, vocab 40000) through "
         f"apply_hybrid_specs at sharding={E5_SHARDING} x mp={E5_MP} (dp "
         f"cut from n/4 to 1), O1, AdamW peak lr {E5_LR:g} (linear "
         f"warmup over {E5_WARMUP} updates) wd {E5_WD:g}, ZeRO "
         f"over sharding, dropout 0.1, B={E5_B} S={E5_S} M={E5_M}, one row "
         f"padded from {E5_PAD_FROM} ({smi}): each rank's blocks "
         f"{e0['shapes']}, {e0['n_local'] / 1e6:.1f}M parameters a rank "
         f"({e0['built']['blocks'] / 2**30:.3f} GiB), the model built in "
         f"{e0['built']['seconds']:.1f} s at a peak of "
         f"{max(e['built']['peak'] for e in res) / 2**30:.3f} GiB; warm-up "
         f"{e0['warm_s']:.1f} s; losses " + " ".join(f"{x:.4f}" for x in curve)
         + f" (equal on every rank); median update {step_s * 1e3:.1f} ms "
         f"({tokens / step_s:.1f} tokens/s), updates " + " ".join(
             f"{x * 1e3:.1f}" for x in e0["times"])
         + " ms; share in collectives by rank " + ", ".join(
             f"{100 * c:.1f}%" for c in comm)
         + "; peak memory by rank " + ", ".join(
             f"{e['peak'] / 2**30:.3f} GiB" for e in res))
    _log(f"distributed: (i) rank 0's seconds in collectives over the "
         f"{E5_UPDATES} updates by op/group: " + ", ".join(
             f"{k} {v:.2f}" for k, v in sorted(
                 e0["by_op"].items(), key=lambda kv: -kv[1])))
    _log(f"distributed: (i) launches a rank {e0['launches']} (each rank "
         "exactly the formula)")
    _require(all(e["shapes"] == want_shapes for e in res),
             f"(i) a rank's blocks: {[e['shapes'] for e in res]}")
    _require(all(e["finite"] for e in res), "(i) a non-finite loss")
    _require(all(e["losses"] == e0["losses"] and e["warm"] == e0["warm"]
                 for e in res), "(i) the ranks report different losses")
    _require(curve[-1] < curve[0], f"(i) loss did not fall: {curve}")
    for r, e in enumerate(res):
        _require(e["launches"] == want, f"rank {r}: (i) launches "
                 f"{e['launches']} != {want}")


def _reshard_report(ranks) -> None:
    """Phase 21's (j): check and print."""
    res = [r["reshard"] for r in ranks]
    j0 = res[0]
    ref = j0["ref"]

    def rel(xs):
        return max(abs(a - b) / abs(b) for a, b in zip(xs, ref))
    same = [r["same"]["losses"] == ref and r["same"]["state_equal"]
            and r["same"]["step_count"] == RESHARD_STEPS * 2 for r in res]
    rels = {"mp=4": max(rel(r["mp=4"]["losses"]) for r in res),
            "one process": rel(j0["one"]["losses"])}
    _log(f"distributed: (j) config 5's widths x {RESHARD_LAYERS} layers, "
         f"f32, dropout 0.1: {RESHARD_STEPS} steps at sharding={E5_SHARDING}"
         f" x mp={E5_MP} (losses " + " ".join(f"{x:.6f}" for x in
                                               j0["first"])
         + f"), a sharded save in {j0['save_s']:.2f} s ({j0['bytes']} bytes "
         f"in {j0['files']}; q_proj's leaf {j0['spec']}; full verification "
         f"{j0['valid'] or 'valid'}), {RESHARD_STEPS} more: " + " ".join(
             f"{x:.6f}" for x in ref) + f". Resumed at the same layout: "
         f"losses, parameters and slots bit-equal {same} (load "
         f"{j0['same']['load_s']:.2f} s); at mp=4: " + " ".join(
             f"{x:.6f}" for x in j0["mp=4"]["losses"])
         + f" (load {j0['mp=4']['load_s']:.2f} s); in one process: "
         + " ".join(f"{x:.6f}" for x in j0["one"]["losses"])
         + f" (load {j0['one']['load_s']:.2f} s); largest relative "
         f"difference to the uninterrupted run {rels} (tol {RESHARD_TOL:g})")
    _require(j0["valid"] is None, f"(j) the sharded save: {j0['valid']}")
    _require(all(same), f"(j) the same-layout resume is not bit-exact: "
             f"{same}")
    _require(max(rels.values()) <= RESHARD_TOL, f"(j) resharded resumes "
             f"differ: {rels}")
    _log("distributed: (h), (i), (j) seconds by rank 0: "
         + ", ".join(f"({k}) {v:.1f}"
                     for k, v in ranks[0]["seconds"].items()))


def _pipe_report(ranks, raw, smi: str) -> None:
    """Phase 21's (e)-(g): check and print."""
    from paddle_tpu_torch.distributed.meta_parallel.spmd_pipeline import \
        max_in_flight
    took = [op for op, rs in raw.items()
            if all(rc == 0 and r.get("ok") for rc, r in rs)]
    _log("distributed: (e) gloo's own point-to-point ops on CUDA tensors, "
         "a pair of processes an op: " + "; ".join(
             f"{op}: " + ", ".join(
                 f"rank {i} exit {rc}"
                 + (f" ({r['error']})" if r.get("error") else "")
                 for i, (rc, r) in enumerate(rs))
             for op, rs in raw.items())
         + f"; gloo took {took or 'none of them'}")
    p2p = [r["p2p"] for r in ranks]
    _log("distributed: (e) the port's isend / recv (two tags received in "
         "the other order), isend / irecv and ppermute_shift on CUDA "
         "tensors over gloo, by rank: " + "; ".join(
             f"{p['ok']}" for p in p2p)
         + f"; the handoff's route {p2p[0]['route']}; a 2 MB bf16 handoff "
         + ", ".join(f"{p['handoff_ms']:.3f}" for p in p2p) + " ms")
    _require(all(all(p["ok"].values()) for p in p2p)
             and all(p["route"] == "pinned_host" for p in p2p),
             f"the port's point-to-point ops on CUDA tensors: {p2p}")
    for name, (pp, mp) in PIPE_LAYOUTS.items():
        for sched in ("fill_drain", "1f1b"):
            res = [r["pipe_parity"][(name, sched)] for r in ranks]
            p0 = res[0]
            rel = max(abs(a - b) / abs(b) for r in res
                      for a, b in zip(r["losses"], p0["ref_losses"]))
            same = all(r["losses"] == p0["losses"] for r in res)
            flight = [r["in_flight"] for r in res]
            want_flight = [max_in_flight(sched, pp, PIPE_PARITY_M,
                                         r["stage"]) for r in res]
            _log(f"distributed: (f) {name}, {sched}, f32, dropout 0.1, "
                 f"gpt2_medium widths x {PIPE_PARITY_LAYERS} layers, B="
                 f"{PIPE_PARITY_M} in {PIPE_PARITY_M} microbatches, S="
                 f"{DIST_S}: losses " + " ".join(
                     f"{x:.6f}" for x in p0["losses"])
                 + f" against one process's, largest relative difference "
                 f"{rel:.3e} (tol {DIST_LOSS_TOL:g}); parameters worst "
                 f"{p0['worst'][0]} {p0['worst'][1]:.3e} (tol "
                 f"{DIST_PARAM_TOL:g}), the key bias {p0['key_bias']:.3e} "
                 f"(tol {DIST_KEY_BIAS_TOL:g})"
                 + (f"; bit-equal to fill_drain {p0['bit_equal']}"
                    if sched == "1f1b" else "")
                 + f"; in flight by rank {flight} (timetable {want_flight})"
                 + f"; {p0['seconds']:.2f} s for {DIST_PARITY_STEPS} steps")
            _require(p0["keys_equal"] and same and rel <= DIST_LOSS_TOL,
                     f"(f) {name} {sched}: losses {rel}, same {same}")
            _require(p0["worst"][1] <= DIST_PARAM_TOL
                     and p0["key_bias"] <= DIST_KEY_BIAS_TOL,
                     f"(f) {name} {sched}: parameters {p0['worst']}, key "
                     f"bias {p0['key_bias']}")
            _require(flight == want_flight, f"(f) in flight {flight}")
            if sched == "1f1b":
                _require(p0["bit_equal"], f"(f) {name}: 1f1b and "
                         "fill_drain differ")
    for r, res in enumerate(ranks):
        stage_pp2, stage_pp4 = r // 2, r
        want = {k: sum(_pipe_want(st, pp, mp, PIPE_PARITY_LAYERS,
                                  PIPE_PARITY_M, 2 * DIST_PARITY_STEPS)[k]
                       for st, pp, mp in ((stage_pp2, 2, 2),
                                          (stage_pp4, 4, 1)))
                for k in res["launches_pipe_parity"]}
        _require(res["launches_pipe_parity"] == want,
                 f"rank {r}: (f)'s launch counts "
                 f"{res['launches_pipe_parity']} != {want}")
        for key, n in (("launches_pipe", PIPE_UPDATES),
                       ("launches_pipe_forward", PIPE_FWD_UPDATES)):
            want = _pipe_want(r // 2, 2, 2, 24, PIPE_M, n)
            _require(res[key] == want, f"rank {r}: (g)'s launch counts "
                     f"({key}) {res[key]} != {want}")
    _pipe_timed_report(ranks, "pipe", "1F1B, pretraining_loss", "1f1b",
                       PIPE_UPDATES, smi)
    _pipe_timed_report(ranks, "pipe_forward", "config 4's own loss style "
                       "crit(layer(ids), labels) (the fill-drain forward, "
                       "the last stage's logits broadcast over pp)",
                       "fill_drain", PIPE_FWD_UPDATES, smi)
    _log(f"distributed: launches a rank, (g) 1F1B {ranks[0]['launches_pipe']}"
         f", (g) config 4's loss style {ranks[0]['launches_pipe_forward']}, "
         f"(f) {ranks[0]['launches_pipe_parity']} (each rank exactly the "
         "formula)")


def _pipe_timed_report(ranks, key: str, style: str, sched: str,
                       updates: int, smi: str) -> None:
    """(g) in one loss style: check the losses, update counts and
    in-flight maxima; print the update time, the collective split and
    the peaks."""
    import numpy as np
    from paddle_tpu_torch.distributed.meta_parallel.spmd_pipeline import \
        max_in_flight
    timed = [r[key] for r in ranks]
    losses = timed[0]["losses"]
    _require(all(np.isfinite(r["losses"]).all() for r in timed)
             and all(r["losses"] == losses for r in timed),
             f"(g) {key}: losses by rank {[r['losses'] for r in timed]}")
    _require(losses[-1] < losses[0], f"(g) {key}: loss did not decrease: "
             f"{losses}")
    _require(all(r["updates"] == updates for r in timed),
             f"(g) {key}: update counts")
    flight = [r["in_flight"] for r in timed]
    want_flight = [max_in_flight(sched, 2, PIPE_M, r["stage"])
                   for r in timed]
    _require(flight == want_flight, f"(g) {key}: in flight {flight} != "
             f"the timetable's {want_flight}")
    step_s = float(np.median(timed[0]["times"]))

    def share(r, pick):
        return 100.0 * sum(v for k, v in r["by_op"].items() if pick(k)) \
            / sum(r["times"])

    def handoff(k):
        return k.endswith("/pp") and k.split("/")[0] in (
            "isend", "isend_wait", "recv")
    parts = {
        "mp all-reduce": lambda k: k == "all_reduce/mp",
        "pp handoff": handoff,
        "pp gradient all-reduce": lambda k: k == "all_reduce/pp",
        # 1F1B: the loss, and in it the last stage's wait for the first
        # stage's drain; the forward style: the logits
        "pp broadcast": lambda k: k == "broadcast/pp",
        "other": lambda k: k not in ("all_reduce/mp", "all_reduce/pp",
                                     "broadcast/pp") and not handoff(k)}
    _log(f"distributed: (g) gpt2_medium (BASELINE config 4's model) pp=2 x "
         f"mp=2, {style}, B={PIPE_B} in {PIPE_M} microbatches, S={DIST_S}, "
         f"O1, AdamW, dropout 0.1, four ranks on one card, the handoff "
         f"through pinned host buffers ({smi}): losses " + " ".join(
             f"{x:.4f}" for x in losses)
         + f"; median update {step_s * 1e3:.1f} ms ("
         f"{PIPE_B * DIST_S / step_s:.1f} tokens/s), updates " + " ".join(
             f"{x * 1e3:.1f}" for x in timed[0]["times"])
         + f" ms; share of the {updates} updates in collectives by rank: "
         + "; ".join(f"rank {i} " + ", ".join(
             f"{n} {share(r, f):.1f}%" for n, f in parts.items())
             for i, r in enumerate(timed))
         + "; peak memory by rank " + ", ".join(
             f"{r['peak'] / 2**30:.3f} GiB" for r in timed)
         + f"; in flight by rank {flight} (timetable {want_flight}); "
         f"handoffs sent/received by rank {[r['handoffs'] for r in timed]}")
    _log(f"distributed: (g) {key}: seconds in collectives over the "
         f"{updates} updates by rank and op/group: " + "; ".join(
             f"rank {i} " + ", ".join(
                 f"{k} {v:.2f}" for k, v in sorted(
                     r["by_op"].items(), key=lambda kv: -kv[1]))
             for i, r in enumerate(timed)))


# -- phase 22: vision ----------------------------------------------------------
# BASELINE config 1 (bench.py:255-292) and config 2 (bench.py:294-351)
LENET_B = 64
LENET_EPOCHS = 4
LENET_SAMPLES = 1024
VISION_B = 256
VISION_RUNS, VISION_STEPS, VISION_WARMUP = 3, 10, 3
# bench.py's count of a ResNet-50 step: B * 3 * 4.1e9 FLOPs (4.1 G a
# forward image, the backward twice that; that file's count, which
# takes 4.1 GMAC as 4.1 GFLOP)
R50_FLOPS_PER_IMAGE_STEP = 3 * 4.1e9
# (c): ResNet-18 f32 on the card against the CPU, the same weights and
# batch, the card's run under cudnn.allow_tf32 on so that the port's own
# choice keeps its convolutions f32. cuDNN's and the CPU's convolutions
# sum in other orders and the weight-gradient kernels may use atomics, so
# runs compare within tolerance, not bits: losses, parameters and BN
# buffers after two steps within 1e-4 of the largest magnitude (a
# parameter near 0 within 1e-7 absolute); the first-pass gradients, in
# NCHW and in the channels-last layout the TrainStep takes, per tensor in
# the L2-relative form of tests/test_e2e_models.py within 2e-4: 20x the
# 1.0e-5 the f32 card read, and under the gap that PyTorch's own TF32
# conv puts into its weight gradient, printed beside it. A step's update
# is not held so: at lr 1e-3 a BN weight's update is about 1e-5, and the
# f32 weight near 1.0 holds it only in 1.2e-7 (1%) steps, so that
# rounding, not the gradient, would set the reading
VISION_PARITY_TOL = 1e-4
VISION_PARITY_FLOOR = 1e-7
VISION_GRAD_L2_TOL = 2e-4
# (e): the folded ResNet-50's eval logits against the unfolded ones
FOLD_TOL = 1e-4
# (b)'s channels-last ms a step, which phase 24 prints beside its dp run
_R50_ONE_PROCESS = {}
VGG_B, VGG_STEPS = 16, 3
VISION_PROFILE_GROUPS = (
    ("layout transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "implicit",
                              "cudnn", "conv", "xmma", "Conv")),
    ("batch norm backward", ("batch_norm",)),
    ("pools", ("pool", "Pool")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("copies and casts", ("copy_kernel", "CatArrayBatched")),
    ("elementwise", ("elementwise_kernel",)),
    ("reductions", ("reduce_kernel", "welford", "Welford")),
)


def _vision_ce(amp: bool):
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.nn import functional as F

    def loss_fn(layer, xb, yb):
        if not amp:
            return F.cross_entropy(layer(xb), yb)
        with auto_cast(level="O1"):
            return F.cross_entropy(layer(xb), yb)
    return loss_fn


def _timed_steps(fn, tag: str) -> float:
    """Median over VISION_RUNS runs of VISION_STEPS calls of ``fn`` (each
    run ends in a synchronize) of the ms a call."""
    import numpy as np
    import torch
    runs = []
    for _ in range(VISION_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VISION_STEPS):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / VISION_STEPS)
    _log(f"{tag}: runs of {VISION_STEPS} steps " + " ".join(
        f"{r:.3f}" for r in runs) + " ms/step")
    return float(np.median(runs))


def _vision_lenet(smi: str) -> None:
    """(a) BASELINE config 1: LeNet, eager, B=64, Momentum(0.01)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    model = LeNet(device="cuda")
    opt = Momentum(learning_rate=0.01, parameters=model.parameters())
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(LENET_B, 1, 28, 28)).astype(np.float32), device="cuda")
    y = torch.zeros(LENET_B, dtype=torch.int64, device="cuda")

    def one():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    one()
    ms = _timed_steps(one, "vision (a)")
    _log(f"vision (a): LeNet eager B={LENET_B} Momentum(0.01): {ms:.3f} "
         f"ms/step (median of {VISION_RUNS} runs of {VISION_STEPS} steps; "
         f"{smi})")
    model = LeNet(device="cuda", seed=1)
    opt = Momentum(learning_rate=0.01, parameters=model.parameters())
    np.random.seed(0)
    loader = DataLoader(MNIST(num_synthetic=LENET_SAMPLES), places="cuda",
                        batch_size=LENET_B, shuffle=True, drop_last=True)
    losses = []
    for _ in range(LENET_EPOCHS):
        for xb, yb in loader:
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    _log(f"vision (a): {LENET_EPOCHS} epochs of synthetic MNIST "
         f"({LENET_SAMPLES} samples, {len(losses)} steps through "
         f"io.DataLoader): loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean "
         f"of the first 3 {first:.4f}, of the last 3 {last:.4f}")
    _require(all(math.isfinite(v) for v in losses), "LeNet: non-finite loss")
    _require(last < first, f"LeNet did not learn: {first} -> {last}")


def _resnet50_keys(model) -> None:
    """The JAX state-dict layout, and a strict load of the model's own
    arrays into a fresh model through load_jax_weights."""
    from paddle_tpu_torch.models import load_jax_weights
    from paddle_tpu_torch.vision.models import resnet50
    sd = model.state_dict()
    _require(len(sd) == 53 + 53 * 4 + 2, f"{len(sd)} state-dict entries")
    _require("conv1.bias" not in sd and "bn1._mean" in sd
             and "layer1.0.downsample.0.weight" in sd
             and tuple(sd["fc.weight"].shape) == (2048, 1000),
             "ResNet-50 state-dict keys differ from the JAX model's")
    fresh = resnet50(num_classes=1000, device="cpu")
    load_jax_weights(fresh, {k: v.float().cpu().numpy()
                             for k, v in sd.items()})


def _vision_resnet50(smi: str):
    """(b) BASELINE config 2: ResNet-50 at B=256, AMP O1, TrainStep,
    channels-last by the flag, then with the flag off."""
    import torch
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    torch.cuda.reset_peak_memory_stats()
    model = resnet50(num_classes=1000, device="cuda")
    opt = Momentum(learning_rate=0.1, parameters=model.parameters(),
                   momentum=0.9, weight_decay=1e-4)
    step = TrainStep(model, _vision_ce(amp=True), opt)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(VISION_B, 3, 224, 224, device="cuda", generator=g)
    y = torch.randint(0, 1000, (VISION_B,), device="cuda", generator=g)
    t0 = time.perf_counter()
    losses = [float(step(x, y))]
    _log(f"vision (b): first step {(time.perf_counter() - t0) * 1e3:.1f} ms"
         " (cuDNN's heuristics pick each shape's algorithms)")
    losses += [float(step(x, y)) for _ in range(VISION_WARMUP - 1)]
    _require(model.conv1.weight.is_contiguous(
        memory_format=torch.channels_last), "conv weights not channels-last")
    for flag in (True, False):
        tag = f"vision (b) channels_last={flag}"
        with flag_scope("jit_channels_last", flag):
            step(x, y)                    # lay the weights out
            ms = _timed_steps(lambda: step(x, y), tag)
            _profile_step(tag, lambda: float(step(x, y)),
                          VISION_PROFILE_GROUPS, step_ms=ms)
        imgs = VISION_B / (ms / 1e3)
        if flag:
            _R50_ONE_PROCESS["ms"] = ms
        mfu = VISION_B * R50_FLOPS_PER_IMAGE_STEP / (ms / 1e3) \
            / PEAK_FLOPS["bfloat16"]
        _log(f"vision (b): ResNet-50 B={VISION_B} AMP O1 Momentum "
             f"channels_last={flag}: {ms:.3f} ms/step, {imgs:.1f} img/s, "
             f"MFU {mfu:.4f} (bench.py's count, B*3*4.1e9 FLOPs a step, "
             f"against 989 TFLOP/s bf16 dense; {smi})")
    peak = torch.cuda.max_memory_allocated()
    _log(f"vision (b): peak device memory {peak / 2**30:.3f} GiB over the "
         f"run (bf16 activations, f32 parameters, gradients and momentum)")
    losses.append(float(step(x, y)))
    _log("vision (b): losses " + " ".join(f"{v:.4f}" for v in losses))
    _require(all(math.isfinite(v) for v in losses), "ResNet-50: non-finite")
    _require(bool((model.bn1._mean != 0).any())
             and bool((model.bn1._variance != 1).any()),
             "ResNet-50: BN running statistics did not move")
    _resnet50_keys(model)
    return model, x[:8].clone()


def _vision_parity(smi: str) -> None:
    """(c) ResNet-18 float32, two TrainStep steps on the card and on the
    CPU from the same weights and batch; then the TF32 gap."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    x = np.random.default_rng(6).normal(size=(4, 3, 64, 64)) \
        .astype(np.float32)
    y = np.array([0, 3, 5, 9], np.int64)
    weights = resnet18(num_classes=10, device="cpu", seed=3).state_dict()

    def build(dev):
        m = resnet18(num_classes=10, device=dev)
        m.load_state_dict(weights)
        return m

    runs = {}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for dev in ("cpu", "cuda"):
            torch.backends.cudnn.allow_tf32 = True
            grads = {}
            for layout in ("NCHW", "channels-last"):
                m = build(dev)
                xt = torch.tensor(x, device=dev)
                if layout == "channels-last":
                    m = m.to(memory_format=torch.channels_last)
                    xt = xt.contiguous(memory_format=torch.channels_last)
                F.cross_entropy(m(xt), torch.tensor(y, device=dev)) \
                    .backward()
                grads.update({f"{k} ({layout})": p.grad.double().cpu()
                              for k, p in m.named_parameters()})
            m = build(dev)
            step = TrainStep(m, _vision_ce(amp=False),
                             Momentum(1e-3, parameters=m.parameters()))
            losses = [float(step(x, y)) for _ in range(2)]
            runs[dev] = (losses, grads, {k: v.double().cpu()
                                         for k, v in m.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (lc, gc, sc), (lg, gg, sg) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    worst, raw = {}, {}
    for k, v in sc.items():
        raw[k] = float((sg[k] - v).abs().max())
        d = ((sg[k] - v).abs() - VISION_PARITY_FLOOR).clamp(min=0)
        worst[k] = float(d.max() / v.abs().max().clamp(min=1e-12))
    kmax = max(worst, key=worst.get)
    kraw = max(raw, key=raw.get)
    gl2 = {k: float((gg[k] - v).norm() / (v.norm() + 1e-12))
           for k, v in gc.items()}
    gmax = max(gl2, key=gl2.get)
    _log(f"vision (c): ResNet-18 f32 [4, 3, 64, 64], two TrainStep steps, "
         f"card under cudnn.allow_tf32 on {lg} vs CPU {lc}: loss rel "
         f"{loss_err:.3e}; parameters and BN buffers worst "
         f"{worst[kmax]:.3e} ({kmax}; largest absolute difference "
         f"{raw[kraw]:.3e}, {kraw}); first-pass gradients in both layouts "
         f"per-tensor L2-relative worst {gl2[gmax]:.3e} ({gmax}), median "
         f"{float(np.median(list(gl2.values()))):.3e}, limit "
         f"{VISION_GRAD_L2_TOL:g} ({smi})")
    _require(loss_err < VISION_PARITY_TOL, "ResNet-18 card loss differs")
    _require(worst[kmax] < VISION_PARITY_TOL, f"{kmax} differs")
    _require(gl2[gmax] < VISION_GRAD_L2_TOL, f"{gmax} gradient differs")
    # TF32: the port's f32 conv ignores the global flag; PyTorch's own
    # conv takes TF32 under it
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(32, 64, 56, 56, device="cuda", generator=g)
    w = torch.randn(64, 64, 3, 3, device="cuda", generator=g) * 0.05
    cot = torch.randn(32, 64, 56, 56, device="cuda", generator=g)
    w.requires_grad_(True)
    try:
        out, gw = {}, {}
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = flag
            out["port", flag] = F.conv2d(a, w, padding=1)
            o = torch.nn.functional.conv2d(a, w, padding=1)
            gw[flag], = torch.autograd.grad((o * cot).sum(), w)
            out["torch", flag] = o.detach()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    ref = out["torch", False]
    same = torch.equal(out["port", True], out["port", False])
    gap = float((out["torch", True] - ref).abs().max() / ref.abs().max())
    ggap = float((gw[True] - gw[False]).norm() / gw[False].norm())
    _log(f"vision (c): [32, 64, 56, 56] 3x3 conv: the port's f32 conv with "
         f"cudnn.allow_tf32 on is bit-equal to off: {same}; PyTorch's own "
         f"conv under TF32 is {gap:.3e} (of the largest output) from f32, "
         f"its weight gradient {ggap:.3e} (L2-relative)")
    _require(same, "the port's f32 conv follows the global TF32 flag")


def _vision_vgg(smi: str) -> None:
    """(d) VGG-16 at B=16, AMP O1: both classifier dropouts through the
    fused dropout kernel."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import vgg16
    model = vgg16(num_classes=1000, device="cuda")
    step = TrainStep(model, _vision_ce(amp=True),
                     Momentum(0.01, parameters=model.parameters()))
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(VGG_B, 3, 224, 224, device="cuda", generator=g)
    y = torch.randint(0, 1000, (VGG_B,), device="cuda", generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(x, y)) for _ in range(VGG_STEPS)]
    ms = (time.perf_counter() - t0) * 1e3 / VGG_STEPS
    _log(f"vision (d): VGG-16 B={VGG_B} AMP O1 losses "
         + " ".join(f"{v:.4f}" for v in losses)
         + f", {ms:.1f} ms/step over {VGG_STEPS} steps, the first included"
         f" ({smi})")
    _require(all(math.isfinite(v) for v in losses), "VGG-16: non-finite")


def _vision_fold(model, x) -> None:
    """(e) fold_conv_bn on phase (b)'s ResNet-50 in eval."""
    import torch
    from paddle_tpu_torch.inference.passes import fold_conv_bn
    model.eval()
    with torch.no_grad():
        before = model(x)
        n = fold_conv_bn(model)
        after = model(x)
    err = float((after - before).abs().max() / before.abs().max())
    _log(f"vision (e): fold_conv_bn folded {n} pairs of ResNet-50; eval "
         f"logits at [{x.shape[0]}, 3, 224, 224] f32 within {err:.3e} of "
         f"the unfolded model's")
    _require(n == 53, f"fold_conv_bn folded {n} pairs, expected 53")
    _require(err < FOLD_TOL, f"folded logits differ by {err}")


def phase_vision(smi: str) -> dict:
    """(a) BASELINE config 1 (LeNet eager), (b) config 2 (ResNet-50
    TrainStep AMP O1, channels-last on and off), (c) ResNet-18 f32 card
    against CPU and the TF32 gap, (d) VGG-16 O1 with both dropouts
    through row 8, (e) fold_conv_bn on (b)'s model. Counts are set to 0
    before (a); (a)-(c) must launch no kernel of the port, (d) row 8
    exactly twice a dropout a step. Returns the phase's launches."""
    from paddle_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    t = time.perf_counter()
    _vision_lenet(smi)
    _log(f"vision: (a) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    model, x8 = _vision_resnet50(smi)
    _log(f"vision: (b) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _vision_parity(smi)
    _log(f"vision: (c) took {time.perf_counter() - t:.1f} s")
    _path_launches({}, "vision (a)-(c)")
    t = time.perf_counter()
    _vision_vgg(smi)
    _log(f"vision: (d) took {time.perf_counter() - t:.1f} s")
    got = _path_launches({"fused_dropout": 2 * 2 * VGG_STEPS}, "vision (d)")
    t = time.perf_counter()
    _vision_fold(model, x8.float())
    _log(f"vision: (e) took {time.perf_counter() - t:.1f} s")
    _log(f"vision: launches {got}")
    return {"vision": _path_launches(got, "vision (e)")}


# -- phase 23: MoE ------------------------------------------------------------
# bench.py --moe's gpt2_345m_8e (bench.py:1608): gpt2_medium with 8
# experts of ffn_size hidden in every second layer, top-2 at capacity
# factor 2, trained at bench_gpt2_345m's configuration (B=8, S=1024, O1,
# dropout 0.1, AdamW 1e-4, decay 0.01) on crit + moe_loss
# (bench.py:1534-1536)
MOE_CFG = dict(moe_experts=8, moe_every=2)
MOE_STEPS = 10
# (b) the sort and einsum paths from the same parameters and seed words
# under O1: one router, the same kernels; the combines round the sum of a
# token's two products in another order (the einsum's matmul fuses a
# multiply-add), so a later bf16 cast may round an element to its
# neighbour, as between the kernels and their plain versions: phase 6's
# limits
MOE_MODE_LOSS_TOL, MOE_MODE_GRAD_TOL = AMP_LOSS_TOL, AMP_GRAD_TOL
# (c) ep = 4 ranks on the one card over gloo, gpt2_medium widths x 4
# layers (2 MoE), B=8, S=1024, dropout 0.1: f32 parity with one process
# at capacity factor E (nothing dropped locally or globally, so the
# routes are one process's) on the data loss (the aux loss is a mean of
# per-rank values under ep), MOE_EP_STEPS steps; then one O1 step of
# (a)'s loss at factor 2
MOE_EP, MOE_EP_LAYERS, MOE_EP_STEPS = 4, 4, 3
# (d) generate over the static cache on (a)'s model at factor E, then
# phase 3's first requests through the serving engine
MOE_GEN_B, MOE_GEN_S0, MOE_GEN_NEW = 2, 32, 16
MOE_SERVE_REQUESTS = 8
# a profiled step's device time: kernels launched inside the MoE layer's
# profiler ranges (named as the JAX ops), by the autograd node of their
# backward, or inside the optimizer's update; the rest by kernel name
# (PROFILE_GROUPS)
MOE_OP_GROUPS = (
    ("expert matmuls (f32)", ("aten::bmm",)),
    ("routing", ("moe_routing", "SoftmaxBackward", "LogsumexpBackward")),
    ("dispatch/combine", ("moe_dispatch", "moe_combine", "IndexBackward",
                          "IndexCopyBackward")),
    ("expert bias, gelu", ("expert_ffn",)),
    ("optimizer", ("moe_phase_optimizer",)),
)


def _moe_model(layers: int = 24, **cfg_kw):
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium)
    cfg = gpt2_medium(num_layers=layers, **dict(MOE_CFG, **cfg_kw))
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        with auto_cast(level="O1"):
            return crit(layer(ids), labels) + layer.moe_loss()
    return cfg, model, loss_fn


def _moe_profile(step, ids, labels, step_ms: float, smi: str) -> None:
    """One more step under torch.profiler: the busy share and the device
    time by group. A kernel counts to an ``MOE_OP_GROUPS`` group when the
    host op that launched it, or one of its callers, is named in it (the
    MoE layer's ranges, the autograd nodes of their backward, the
    optimizer's update wrapped in a range for this step); every other
    kernel by its name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    opt = step.optimizer
    update = opt.step

    def ranged(*a, **kw):
        with record_function("moe_phase_optimizer"):
            return update(*a, **kw)
    opt.step = ranged
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(ids, labels))
            wall = time.perf_counter() - t0
    finally:
        del opt.step
    # the ranges' own spans on the device timeline are not kernels
    ranges = {name for _, keys in MOE_OP_GROUPS for name in keys} | {
        e.name for e in prof.events()
        if getattr(e, "is_user_annotation", False)}
    by_name = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA and a.key not in ranges:
            by_name[a.key] = by_name.get(a.key, 0.0) + \
                a.self_device_time_total
    busy = sum(by_name.values())
    groups, taken = {}, {}
    for evt in prof.events():
        kerns = getattr(evt, "kernels", None) or ()
        if evt.device_type != DeviceType.CPU or not kerns:
            continue
        chain, e = [], evt
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        group = next((g for g, keys in MOE_OP_GROUPS
                      if any(k in name for name in (
                          chain[:1] if g.startswith("expert matmuls")
                          else chain) for k in keys)), None)
        if group is None:
            continue
        for k in kerns:
            us = float(getattr(k, "duration", 0.0))
            groups[group] = groups.get(group, 0.0) + us
            taken[k.name] = taken.get(k.name, 0.0) + us
    for name, us in by_name.items():
        left = max(0.0, us - taken.get(name, 0.0))
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + left
    busy_ms = busy / 1e3
    _log(f"moe: (a) profiled step {wall * 1e3:.1f} ms wall, kernels busy "
         f"{busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}% of it, "
         f"{100 * busy_ms / step_ms:.1f}% of the unprofiled median step "
         f"{step_ms:.3f} ms) ({smi})")
    _log("moe: (a) device time by group: " + ", ".join(
        f"{g} {us / 1e3:.3f} ms ({100 * us / max(busy, 1e-9):.1f}%)"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))
        + ("" if taken else " (no kernel was attributed to a host op: "
           "the op groups are empty)"))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"moe:   {us / 1e3:9.3f} ms {100 * us / max(busy, 1e-9):5.1f}% "
             f"{name[:90]}")


def _moe_train(smi: str):
    """(a) bench.py's gpt2_345m_8e through TrainStep: exact launches,
    step time, tokens/s, peak memory, a profiled step, then the router
    health of one eager forward. Returns the model, its loss_fn, step,
    batch and launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cfg, model, loss_fn = _moe_model()
    n_all = sum(p.numel() for p in model.parameters())
    n_exp = sum(p.numel() for n, p in model.named_parameters()
                if ".moe.experts." in n)
    step = TrainStep(model, loss_fn, AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters(),
        weight_decay=TRAIN_WD), seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size,
                          (TRAIN_B, TRAIN_S)).astype(np.int32)
    torch.cuda.synchronize()
    _log(f"moe: (a) gpt2_medium + {cfg.moe_experts} experts every "
         f"{cfg.moe_every}nd layer ({len(cfg.moe_layer_indices())} MoE "
         f"layers, top-{cfg.moe_top_k}, capacity factor "
         f"{cfg.moe_capacity_factor}): {n_all} parameters, {n_exp} in the "
         f"experts; model and step built in {time.perf_counter() - t:.1f} s")
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))
        times.append(time.perf_counter() - t0)
    L, n = cfg.num_layers, MOE_STEPS
    want = dict(_zero_launches(), flash_attention_fwd=L * n,
                flash_attention_bwd=L * n, chunked_ce_lse=n,
                chunked_ce_dlogits=n, fused_dropout=2 * (1 + 2 * L) * n)
    launches = _path_launches(want, "moe (a)")
    _require(all(math.isfinite(x) for x in losses), "moe: non-finite loss")
    _require(losses[-1] < losses[0], f"moe: loss did not decrease: "
             f"{losses[0]} -> {losses[-1]}")
    step_s = float(np.median(times[2:]))
    tokens = TRAIN_B * TRAIN_S
    _log("moe: (a) losses " + " ".join(f"{x:.4f}" for x in losses))
    _log(f"moe: (a) B={TRAIN_B} S={TRAIN_S} O1 dropout "
         f"{cfg.hidden_dropout_prob} AdamW ({smi}): step 1 "
         f"{times[0] * 1e3:.1f} ms, median over steps 3-{MOE_STEPS} "
         f"{step_s * 1e3:.2f} ms/step, {tokens / step_s:.1f} tokens/s, "
         f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
         f" GiB; launches over {MOE_STEPS} steps {launches} (the dense "
         "step's formula)")
    _moe_profile(step, ids, labels, step_s * 1e3, smi)
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(ids).cuda())
    arr = model.gpt.moe_layer_stats().double().cpu().numpy()
    model.train()
    _log(f"moe: (a) router health of one eager forward (eval, bench.py's "
         f"reading): drop {100 * arr[:, 2].mean():.2f}%, balance "
         f"{100 * arr[:, 4].mean():.2f}, entropy {arr[:, 3].mean():.4f} "
         f"nats over {arr.shape[0]} layers; per layer drop % "
         + " ".join(f"{100 * x:.1f}" for x in arr[:, 2]))
    return model, loss_fn, step, (ids, labels), launches


def _moe_modes(model, loss_fn, batch, smi: str) -> None:
    """(b) One forward and backward of (a)'s step under each dispatch
    mode from the same parameters and seed words: loss and gradients
    within phase 6's limits; then the dispatch plus combine of each at
    T = 8192 timed."""
    import torch
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.core.random import dropout_generator
    from paddle_tpu_torch.incubate.moe import (
        MOE_STATS, einsum_combine, einsum_dispatch, moe_capacity,
        reset_moe_stats, sort_combine, sort_dispatch, topk_routing)
    ids, labels = (torch.from_numpy(b).cuda() for b in batch)
    res = {}
    for mode in ("sort", "einsum"):
        for p in model.parameters():
            p.grad = None
        reset_moe_stats()
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator().manual_seed(23)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with flag_scope("moe_dispatch", mode), dropout_generator(g):
            loss = loss_fn(model, ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        res[mode] = (float(loss), [p.grad.detach().clone()
                                   for p in model.parameters()],
                     time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2**30,
                     MOE_STATS[f"{mode}_dispatches"])
    for p in model.parameters():
        p.grad = None
    (ls, gs, ts, ms_, ns), (le, ge, te, me, ne) = res["sort"], res["einsum"]
    num = sum(float(torch.sum((a - b).double() ** 2)) for a, b in zip(gs, ge))
    den = sum(float(torch.sum(b.double() ** 2)) for b in ge)
    gerr = math.sqrt(num / den)
    lerr = abs(ls - le) / abs(le)
    del gs, ge, res
    torch.cuda.empty_cache()
    _log(f"moe: (b) one O1 forward and backward of (a)'s model, sort "
         f"against einsum (each {ns} / {ne} MoE dispatches): loss {ls:.6f}"
         f" / {le:.6f}, relative {lerr:.3e} (tol {MOE_MODE_LOSS_TOL:g}); "
         f"gradients' error norm over their norm {gerr:.3e} (tol "
         f"{MOE_MODE_GRAD_TOL:g}); {ts * 1e3:.1f} / {te * 1e3:.1f} ms, peak "
         f"{ms_:.3f} / {me:.3f} GiB ({smi})")
    _require(ns == ne == len(model.cfg.moe_layer_indices()),
             f"moe (b): dispatch counts {ns} {ne}")
    _require(lerr <= MOE_MODE_LOSS_TOL and gerr <= MOE_MODE_GRAD_TOL,
             f"moe (b): sort and einsum disagree: loss {lerr}, grads {gerr}")
    # the dispatch and combine alone at (a)'s per-layer shape: the f32
    # stream of the mixed stack, T = B * S tokens
    E, k, cf = model.cfg.moe_experts, model.cfg.moe_top_k, \
        model.cfg.moe_capacity_factor
    T, D = TRAIN_B * TRAIN_S, model.cfg.hidden_size
    C = moe_capacity(T, cf, E)
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(T, D, device="cuda", generator=gen)
    r = topk_routing(torch.randn(T, E, device="cuda", generator=gen), k, C)
    eo = torch.randn(E, C, D, device="cuda", generator=gen)
    with torch.no_grad():
        same = (torch.equal(sort_dispatch(x, r, E, C),
                            einsum_dispatch(x, r, E, C)),
                _rel_err(sort_combine(eo, r, C), einsum_combine(eo, r, C)))
        t_sort = (_median_ms(lambda: sort_dispatch(x, r, E, C)),
                  _median_ms(lambda: sort_combine(eo, r, C)))
        t_ein = (_median_ms(lambda: einsum_dispatch(x, r, E, C)),
                 _median_ms(lambda: einsum_combine(eo, r, C)))
    _log(f"moe: (b) dispatch + combine at T={T} D={D} E={E} C={C} top-{k} "
         f"f32 ({smi}): sort {t_sort[0]:.4f} + {t_sort[1]:.4f} = "
         f"{sum(t_sort):.4f} ms, einsum {t_ein[0]:.4f} + {t_ein[1]:.4f} = "
         f"{sum(t_ein):.4f} ms; dispatches bit-equal {same[0]}, combines "
         f"{same[1]:.3e} apart (relative to the largest)")
    _require(same[0] and same[1] <= 1e-6, f"moe (b): the paths' data "
             f"movement differs: {same}")


def _moe_ep_model(amp: bool, cf: float):
    """(c)'s model: gpt2_medium widths x MOE_EP_LAYERS, seed 0; the data
    loss in f32, or (a)'s loss under O1."""
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    cfg, model, loss_fn = _moe_model(MOE_EP_LAYERS, moe_capacity_factor=cf)
    if amp:
        return model, loss_fn
    crit = GPTPretrainingCriterion()
    return model, lambda layer, ids, labels: crit(layer(ids), labels)


def _moe_ep_reference(path: str) -> list:
    """(c)'s one-process reference on the card: MOE_EP_STEPS f32 steps
    at capacity factor E; its losses and parameters to ``path``."""
    import gc
    import torch
    from paddle_tpu_torch.framework.io import save
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    model, loss_fn = _moe_ep_model(False, float(MOE_CFG["moe_experts"]))
    step = TrainStep(model, loss_fn, AdamW(
        TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
        seed=0)
    ids, labels = _dist_batch(TRAIN_B, TRAIN_S, 6)
    losses = [float(step(ids, labels)) for _ in range(MOE_EP_STEPS)]
    save({"losses": losses, "params": step.state_dict()["params"]}, path)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _moe_ep_rank(out_dir: str) -> None:
    """One rank of (c)'s ep world (a spawned process; phase 1's libraries
    load from ``paddle_tpu_torch/_build``): the f32 parity steps, timed,
    with the collectives' seconds by op, then one O1 step. Writes
    ``moe_rank<r>.pkl``."""
    import gc
    import pickle
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.spmd import P, make_mesh
    from paddle_tpu_torch.framework.io import load
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.monitor import scoped_registry
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    mesh = make_mesh({"ep": MOE_EP})
    env.set_mesh(mesh)
    kernels.reset_launch_counts()
    res = {}
    for tag, amp, cf, n in (("parity", False,
                             float(MOE_CFG["moe_experts"]), MOE_EP_STEPS),
                            ("o1", True, 2.0, 1)):
        torch.cuda.reset_peak_memory_stats()
        model, loss_fn = _moe_ep_model(amp, cf)
        step = TrainStep(model, loss_fn, AdamW(
            TRAIN_LR, parameters=model.parameters(), weight_decay=TRAIN_WD),
            seed=0, mesh=mesh, data_spec=P("ep"))
        ids, labels = _dist_batch(TRAIN_B, TRAIN_S, 6)
        losses, times, comm = [], [], []
        with scoped_registry() as reg:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(ids, labels)))
                times.append(time.perf_counter() - t0)
                comm.append(sum(_comm_by_op(reg).values()))
            by_op = _comm_by_op(reg)
        out = {"losses": losses, "times": times, "by_op": by_op,
               "comm": [b - a for a, b in zip([0.0] + comm, comm)],
               "peak": torch.cuda.max_memory_allocated(),
               "w1": tuple(model.gpt.layers[1].moe.experts.w1.shape),
               "ep_degree": step._ep_degree}
        if tag == "parity":
            params = step.state_dict()["params"]
            if rank == 0:
                ref = load(os.path.join(out_dir, "moe_reference.pdparams"))
                out["ref_losses"] = ref["losses"]
                out.update(_param_errors(params, ref["params"]))
        res[tag] = out
        del step, model
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = {k["name"]: k["launches"] for k in kernels.kernels()}
    res["leaked"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "paddle_tpu"))
    res["backend"] = dist.ParallelEnv().backend
    with open(os.path.join(out_dir, f"moe_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _moe_ep(smi: str) -> dict:
    """(c) ep = 4 over four ranks on the one card: f32 parity against one
    process, timed, the collectives by op, one O1 step, exact launches.
    Returns the launches summed over the ranks."""
    import pickle
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed.spawn_mod import spawn
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ref = _moe_ep_reference(os.path.join(tmp, "moe_reference.pdparams"))
        _log(f"moe: (c) the one-process reference, gpt2_medium widths x "
             f"{MOE_EP_LAYERS} layers + experts, f32, capacity factor "
             f"{MOE_CFG['moe_experts']}, B={TRAIN_B} S={TRAIN_S}: losses "
             + " ".join(f"{x:.6f}" for x in ref)
             + f" ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        spawn("chip_smoke:_moe_ep_rank", args=(tmp,), nprocs=MOE_EP)
        _log(f"moe: (c) the {MOE_EP}-rank world took "
             f"{time.perf_counter() - t:.1f} s")
        ranks = []
        for r in range(MOE_EP):
            with open(os.path.join(tmp, f"moe_rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        _require(not res["leaked"], f"rank {r} imported {res['leaked'][:5]}")
        _require(res["backend"] == "gloo", f"rank {r}: {res['backend']}")
        _require(res["parity"]["ep_degree"] == MOE_EP
                 and res["parity"]["w1"][0] == MOE_CFG["moe_experts"] //
                 MOE_EP, f"rank {r}: ep degree or expert block "
                 f"{res['parity']['ep_degree']} {res['parity']['w1']}")
    p0 = ranks[0]["parity"]
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["parity"]["losses"], p0["ref_losses"]))
    step_ms = [float(np.median(r["parity"]["times"][1:])) * 1e3
               for r in ranks]
    comm = [100 * float(np.median(np.asarray(r["parity"]["comm"][1:])
                                  / np.asarray(r["parity"]["times"][1:])))
            for r in ranks]
    _log(f"moe: (c) ep={MOE_EP}, f32, capacity factor "
         f"{MOE_CFG['moe_experts']}, dropout 0.1, four ranks on one card "
         f"over gloo ({smi}): losses " + " ".join(
             f"{x:.6f}" for x in p0["losses"])
         + f" against one process's, largest relative difference {rel:.3e}"
         f" (tol {DIST_LOSS_TOL:g}); {p0['n_params']} gathered parameters, "
         f"worst {p0['worst'][0]} {p0['worst'][1]:.3e} (tol "
         f"{DIST_PARAM_TOL:g}), the key bias {p0['key_bias']:.3e} (tol "
         f"{2 * TRAIN_LR * MOE_EP_STEPS:g}); median update by rank "
         + ", ".join(f"{x:.1f}" for x in step_ms) + " ms; share in "
         "collectives (comm_* series, host time) by rank "
         + ", ".join(f"{x:.1f}%" for x in comm)
         + "; peak memory by rank " + ", ".join(
             f"{r['parity']['peak'] / 2**30:.3f} GiB" for r in ranks))
    _log("moe: (c) rank 0's seconds in collectives over the "
         f"{MOE_EP_STEPS} f32 steps by op/group: " + ", ".join(
             f"{k} {v:.3f}" for k, v in sorted(
                 p0["by_op"].items(), key=lambda kv: -kv[1])))
    o1 = [r["o1"] for r in ranks]
    _log(f"moe: (c) one O1 step of (a)'s loss at capacity factor 2: loss "
         f"{o1[0]['losses'][0]:.4f}, {o1[0]['times'][0] * 1e3:.1f} ms, peak "
         "memory by rank " + ", ".join(
             f"{r['peak'] / 2**30:.3f} GiB" for r in o1))
    _require(p0["keys_equal"], "moe (c): the gathered state dict's keys")
    _require(rel <= DIST_LOSS_TOL, f"moe (c): losses differ by {rel}")
    _require(p0["worst"][1] <= DIST_PARAM_TOL
             and p0["key_bias"] <= 2 * TRAIN_LR * MOE_EP_STEPS,
             f"moe (c): parameters differ: {p0['worst']}, key bias "
             f"{p0['key_bias']}")
    _require(all(math.isfinite(r["losses"][0]) for r in o1)
             and len({r["losses"][0] for r in o1}) == 1,
             f"moe (c): O1 losses {[r['losses'] for r in o1]}")
    L, n = MOE_EP_LAYERS, MOE_EP_STEPS + 1
    want = dict(_zero_launches(), flash_attention_fwd=L * n,
                flash_attention_bwd=L * n, chunked_ce_lse=n,
                chunked_ce_dlogits=n, fused_dropout=2 * (1 + 2 * L) * n)
    for r, res in enumerate(ranks):
        _require(res["launches"] == want, f"moe (c) rank {r}: launches "
                 f"{res['launches']} != {want}")
    _log(f"moe: (c) launches a rank {ranks[0]['launches']} (each rank "
         "exactly the formula)")
    names = list(want)
    return {n_: sum(r["launches"][n_] for r in ranks) for n_ in names}


def _moe_decode(model, smi: str) -> dict:
    """(d) ``generate`` greedy over the static cache on (a)'s model at
    capacity factor E, exact launches, every token the full forward's
    argmax (near-ties under ``TIE_GAP``); then phase 3's first requests
    through ``ServingEngine``, teacher-forced, with decode p50 and exact
    launches. Returns the launches of both."""
    import numpy as np
    import torch
    from paddle_tpu_torch.incubate.moe import MoELayer
    from paddle_tpu_torch.models import generate
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (Request, SamplingParams,
                                          ServingConfig, ServingEngine)
    cfg = model.cfg
    for m in model.modules():
        if isinstance(m, MoELayer):
            m.capacity_factor = float(m.num_experts)
    model.eval()
    L = cfg.num_layers
    rng = np.random.RandomState(23)
    prompts = rng.randint(0, cfg.vocab_size, (MOE_GEN_B, MOE_GEN_S0))
    generate(model, prompts, max_new_tokens=2,
             decode_strategy="greedy_search")              # first use
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = generate(model, prompts, max_new_tokens=MOE_GEN_NEW,
                   decode_strategy="greedy_search")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    gen = _path_launches({"flash_attention_fwd": L,
                          "paged_decode_attention": L * (MOE_GEN_NEW - 1)},
                         "moe (d) generate")
    tokens = out[:, MOE_GEN_S0:].cpu().numpy()
    checked = _teacher_forced("moe: (d) generate", model,
                              [_Stream(p, tk) for p, tk in
                               zip(prompts, tokens)], TIE_GAP)
    _log(f"moe: (d) generate B={MOE_GEN_B} S0={MOE_GEN_S0} "
         f"{MOE_GEN_NEW} new tokens greedy at capacity factor "
         f"{cfg.moe_experts} in {wall * 1e3:.1f} ms ({smi}); {checked} "
         f"tokens against the full forward; launches {gen}")
    engine = ServingEngine(model, ServingConfig(**SERVE_CFG), device="cuda")
    engine.warmup()
    specs = _slice_specs(cfg.vocab_size)[:MOE_SERVE_REQUESTS]
    kernels.reset_launch_counts()
    states = [engine.submit(Request(p, max_new_tokens=new,
                                    sampling=SamplingParams()))
              for p, new in specs]
    engine.run()
    torch.cuda.synchronize()
    served = {k["name"]: k["launches"] for k in kernels.kernels()}
    stats, summary = engine.stats(), engine.metrics_summary()
    for st, (p, new) in zip(states, specs):
        _require(st.outcome == "completed" and len(st.generated) == new,
                 f"moe (d): request {st.request.request_id} ended "
                 f"{st.outcome} with {len(st.generated)} tokens")
    n_pre, n_dec = stats["prefill_dispatches"], stats["decode_dispatches"]
    _require(served["flash_attention_fwd"] >= L * n_pre > 0
             and served["paged_decode_attention"] == L * n_dec > 0,
             f"moe (d): serving launches {served} for {n_pre} prefill and "
             f"{n_dec} decode dispatches")
    _require(not any(v for k, v in served.items() if k not in (
        "flash_attention_fwd", "paged_decode_attention")),
             f"moe (d): serving launched {served}")
    _teacher_forced("moe: (d) serve", model, states, TIE_GAP)
    _log(f"moe: (d) {len(states)} requests through ServingEngine ({n_pre} "
         f"prefill and {n_dec} decode dispatches, {smi}): "
         f"{summary['tokens_per_sec']:.2f} tokens/s, decode step p50 "
         f"{_ms(summary['decode_step_p50_s'])} p99 "
         f"{_ms(summary['decode_step_p99_s'])}, TTFT p50 "
         f"{_ms(summary['ttft_p50_s'])}; launches {served}")
    engine.shutdown()
    return {n: gen[n] + served[n] for n in gen}


def phase_moe(smi: str) -> dict:
    """(a) GPT-2 345M-8E (bench.py --moe) through TrainStep at O1 with
    exact launches, (b) sort against einsum, (c) ep = 4 on four ranks,
    (d) MoE decode and serving. Counts are set to 0 before each part.
    Returns the launches of (a), (c) summed over the ranks, and (d)."""
    import gc
    import torch
    t = time.perf_counter()
    model, loss_fn, step, batch, train = _moe_train(smi)
    _log(f"moe: (a) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _moe_modes(model, loss_fn, batch, smi)
    _log(f"moe: (b) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    decode = _moe_decode(model, smi)
    _log(f"moe: (d) took {time.perf_counter() - t:.1f} s")
    del model, loss_fn, step
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ep = _moe_ep(smi)
    _log(f"moe: (c) took {time.perf_counter() - t:.1f} s")
    return {"moe": train, "moe_ep": ep, "moe_decode": decode}


# -- phase 24: vision part 2 ----------------------------------------------------
# (a) f32 parity: ResNet-18 at [16, 3, 64, 64], dp = 4 over four ranks on
# the one card (gloo) against one process's step on the global batch, two
# Momentum steps at lr 1e-3: losses within DIST_LOSS_TOL (1e-5)
# relative; parameters and BN running statistics, each tensor's largest
# difference over its largest magnitude (a difference under
# VISION_PARITY_FLOOR, 1e-7, counting as none), within VISION_PARITY_TOL
# (1e-4) or within twice what the same one-process step run in NCHW
# reads against the channels-last one, whichever is larger. The ranks'
# per-channel moments combine in another order than one process's
# Welford pass, and B = 4 a rank takes other cuDNN algorithms than
# B = 16; a BN bias holds only two updates of a gradient that is small by
# cancellation, so such reorderings move it by far more than 1e-4 of
# itself: a CPU rehearsal at these shapes read 1.184e-02 between the two
# layouts of one process (a BN bias; updates 5.483e-03 in L2) and
# 9.893e-06 between dp = 4 and one process, both channels-last; on the
# card (vision2 phase, PR 20, H100 80GB HBM3, 700.00 W) both the NCHW run
# and dp = 4 read 1.839e-03 on layer2.0.bn1.bias, every other tensor
# under 1.3e-4
V2_RANKS = 4
V2_PARITY_B, V2_PARITY_HW, V2_PARITY_STEPS = 16, 64, 2
# (b) BASELINE config 2 through Model.fit under fleet.init: ResNet-50,
# every BN converted to SyncBatchNorm, global batch 256 (64 a rank), 224^2,
# AMP O1, channels-last, Momentum(0.9) under a cosine schedule stepped by
# the LRScheduler callback; V2_WARMUP updates, then V2_TIMED timed ones,
# then one more profiled on rank 0; an evaluate over V2_EVAL images
V2_B, V2_WARMUP, V2_TIMED, V2_EVAL = 256, 2, 3, 64
# (c) max_pool2d(return_mask=True) -> MaxUnPool2D at ResNet's stem
V2_POOL_SHAPE = (32, 64, 112, 112)
# (d), (e): the card against the port's own CPU run, float outputs within
# DET_TOL of their largest magnitude (sums in another order); indices,
# counts and the host-side multiclass_nms equal
DET_TOL = 1e-5
# deform_conv2d's contraction sums C * K = 4608 products a output, and
# the quantized conv's weight gradient B * 28 * 28 = 6272: their f32
# sums in another order sit further apart
DET_SUM_TOL = 1e-4
# roi_align's sample coordinates reach 300 on P2, where an f32 quantum
# is 3.05e-05 px and a bilinear value moves by up to twice the map's
# largest step across one: the op's f32 result sits 1.51e-05 (of the
# largest output) from its float64 evaluation on the CPU, and the card
# read 2.58e-05 from the CPU (vision2 phase, PR 20)
DET_COORD_TOL = 1e-4


_V2_FAILS = []


def _v2_check(cond, msg: str) -> None:
    """Phase 24's checks: a failure is printed and recorded and the phase
    goes on, so one run prints every reading; it fails at its end."""
    if not cond:
        _log(f"vision2: FAILED: {msg}")
        _V2_FAILS.append(msg)


def _o1_net(net):
    """``net`` wrapped so that its forward runs under ``auto_cast(level=
    "O1")`` and returns float32 logits (the JAX ``Model.prepare`` takes
    no AMP setting, so the cast lives in the network)."""
    import torch
    from paddle_tpu_torch.amp import auto_cast

    class O1(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.net = inner

        def forward(self, x):
            with auto_cast(level="O1"):
                return self.net(x).float()
    return O1(net)


class _SynthImageNet:
    """``n`` seeded ImageNet-shaped samples on the card (``distinct`` of
    them, repeated), as phase 22 makes its batch: N(0, 1) images and
    uniform labels from one generator."""

    def __init__(self, n: int, distinct: int, seed: int):
        import torch
        g = torch.Generator(device="cuda").manual_seed(seed)
        self.x = torch.randn(distinct, 3, 224, 224, device="cuda",
                             generator=g)
        self.y = torch.randint(0, 1000, (distinct,), device="cuda",
                               generator=g)
        self.n = n

    def __getitem__(self, i):
        j = i % self.x.shape[0]
        return self.x[j], self.y[j]

    def __len__(self):
        return self.n


def _v2_parity_batch():
    import numpy as np
    rng = np.random.default_rng(6)
    return (rng.normal(size=(V2_PARITY_B, 3, V2_PARITY_HW, V2_PARITY_HW))
            .astype(np.float32),
            (np.arange(V2_PARITY_B) % 10).astype(np.int64))


def _v2_reference(tmp: str) -> list:
    """(a)'s one-process step on the card: the initial ResNet-18 weights
    to ``v2_init.pdparams``, the losses and final state to
    ``v2_reference.pdparams``."""
    import torch
    from paddle_tpu_torch.framework.io import save
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.models import load_jax_weights
    init = resnet18(num_classes=10, device="cuda", seed=3).state_dict()
    save(init, os.path.join(tmp, "v2_init.pdparams"))
    x, y = _v2_parity_batch()
    out = {}
    for cl in (True, False):
        m = resnet18(num_classes=10, device="cuda")
        load_jax_weights(m, {k: v.cpu().numpy() for k, v in init.items()})
        with flag_scope("jit_channels_last", cl):
            step = TrainStep(m, _vision_ce(amp=False), Momentum(
                1e-3, momentum=0.9, parameters=m.parameters()))
            losses = [float(step(x, y)) for _ in range(V2_PARITY_STEPS)]
        out["state" if cl else "state_nchw"] = m.state_dict()
        out["losses" if cl else "losses_nchw"] = losses
        del step, m
    out["init"] = init
    save(out, os.path.join(tmp, "v2_reference.pdparams"))
    torch.cuda.empty_cache()
    return out["losses"]


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _v2_buffers(model):
    return [b for n, b in sorted(model.state_dict().items())
            if n.endswith(("_mean", "_variance"))]


def _v2_params(model):
    return [p for _, p in sorted(model.named_parameters())]


def _v2_errors(state: dict, ref: dict) -> dict:
    """``state`` against the reference's: each tensor's largest
    difference over its largest magnitude (differences under
    VISION_PARITY_FLOOR count as none), the three worst parameters and
    the worst running statistic; the L2 error of each parameter's update
    over the update's L2; the same two for the reference's NCHW run (the
    card's own noise between cuDNN's algorithms)."""
    import numpy as np

    def max_rel(a, r):
        d = np.maximum(np.abs(a - r) - VISION_PARITY_FLOOR, 0.0)
        return float(d.max() / max(np.abs(r).max(), 1e-12))

    out = {}
    for tag, got in (("dp", state), ("nchw", {
            k: np.asarray(v, np.float64)
            for k, v in ref["state_nchw"].items()})):
        rel, upd = {}, {}
        for k, v in ref["state"].items():
            r = np.asarray(v, np.float64)
            rel[k] = max_rel(got[k], r)
            if not k.endswith(("_mean", "_variance")):
                step = r - np.asarray(ref["init"][k], np.float64)
                upd[k] = float(np.linalg.norm(got[k] - r)
                               / max(np.linalg.norm(step), 1e-30))
        stats = {k: v for k, v in rel.items()
                 if k.endswith(("_mean", "_variance"))}
        params = sorted(((k, v) for k, v in rel.items() if k not in stats),
                        key=lambda kv: -kv[1])
        out[tag] = {"params": params[:3],
                    "stats": max(stats.items(), key=lambda kv: kv[1]),
                    "update": max(upd.items(), key=lambda kv: kv[1])}
    return out


def _v2_parity_rank(rank: int, hcg, tmp: str) -> dict:
    """(a) on one rank: the dp = 4 step from the reference's weights."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.framework.io import load
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import load_jax_weights
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    m = resnet18(num_classes=10, device="cuda")
    load_jax_weights(m, load(os.path.join(tmp, "v2_init.pdparams")))
    step = TrainStep(m, _vision_ce(amp=False), Momentum(
        1e-3, momentum=0.9, parameters=m.parameters()),
        mesh=hcg.mesh, data_spec=P("dp"))
    x, y = _v2_parity_batch()
    losses = [float(step(x, y)) for _ in range(V2_PARITY_STEPS)]
    out = {"losses": losses, "buffers": _digest(_v2_buffers(m)),
           "params": _digest(_v2_params(m)),
           "groups": {len(b._data_groups) for b in m.modules()
                      if hasattr(b, "_data_groups")}}
    if rank == 0:
        ref = load(os.path.join(tmp, "v2_reference.pdparams"))
        out["ref_losses"] = ref["losses"]
        out.update(_v2_errors({k: v.double().cpu().numpy() for k, v in
                               m.state_dict().items()}, ref))
    del step, m
    torch.cuda.empty_cache()
    return out


def _v2_fit_rank(rank: int, smi: str) -> dict:
    """(b) on one rank: ResNet-50 through ``Model.fit`` over the fleet's
    dp mesh; per update the host ms, the seconds in collectives (the
    registry's ``comm_*``) and the part of them in the batch norms'
    statistics collectives; then an evaluate and the state's digests."""
    import numpy as np
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.monitor import scoped_registry
    from paddle_tpu_torch.nn import functional_vision as fv
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay
    from paddle_tpu_torch.vision.models import resnet50
    n_updates = V2_WARMUP + V2_TIMED
    stats_s = [0.0]
    all_ranks = fv._all_ranks

    def timed_all_ranks(t, groups):
        t0 = time.perf_counter()
        try:
            return all_ranks(t, groups)
        finally:
            stats_s[0] += time.perf_counter() - t0
    fv._all_ranks = timed_all_ranks
    torch.cuda.reset_peak_memory_stats()
    resnet = nn.SyncBatchNorm.convert_sync_batchnorm(
        resnet50(num_classes=1000, device="cuda"))
    net = _o1_net(resnet)
    sched = CosineAnnealingDecay(0.1, T_max=n_updates)
    model = Model(net)
    model.prepare(Momentum(sched, momentum=0.9, parameters=net.parameters(),
                           weight_decay=1e-4),
                  nn.CrossEntropyLoss(), Accuracy())
    rec = {"times": [], "comm": [], "stats": [], "losses": [], "lrs": []}

    class Timer(Callback):
        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            self.c0 = sum(_comm_by_op(reg).values())
            self.s0 = stats_s[0]

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            rec["times"].append(time.perf_counter() - self.t0)
            rec["comm"].append(sum(_comm_by_op(reg).values()) - self.c0)
            rec["stats"].append(stats_s[0] - self.s0)
            rec["losses"].append(logs["loss"])
            rec["lrs"].append(model._optimizer.get_lr())

    loader = DataLoader(_SynthImageNet(V2_B * n_updates, V2_B, seed=0),
                        places="cuda", batch_size=V2_B,
                        use_buffer_reader=False)
    with scoped_registry() as reg:
        model.fit(loader, epochs=1, verbose=0, callbacks=[Timer()])
        by_op = _comm_by_op(reg)
    # one more update, profiled on rank 0 (every rank joins its
    # collectives)
    extra = _SynthImageNet(V2_B, V2_B, seed=1)
    x, y = extra.x, extra.y
    busy = None
    if rank == 0:
        busy = _profile_step("vision2 (b) rank 0", lambda: model.train_batch(
            [x], [y]), VISION_PROFILE_GROUPS,
            step_ms=1e3 * float(np.median(rec["times"][V2_WARMUP:])))
    else:
        model.train_batch([x], [y])
    fv._all_ranks = all_ranks
    peak = torch.cuda.max_memory_allocated()
    ev_data = _SynthImageNet(V2_EVAL, V2_EVAL, seed=2)
    ev = model.evaluate(DataLoader(ev_data, places="cuda",
                                   batch_size=V2_EVAL,
                                   use_buffer_reader=False), verbose=0)
    sync = sum(isinstance(b, nn.SyncBatchNorm) for b in resnet.modules())
    return dict(rec, by_op=by_op, busy=busy, peak=peak, eval=ev,
                sync_bns=sync, buffers=_digest(_v2_buffers(resnet)),
                params=_digest(_v2_params(resnet)),
                cl=resnet.conv1.weight.is_contiguous(
                    memory_format=torch.channels_last),
                steps=model._train_step.step_count)


def _vision2_rank(out_dir: str, smi: str) -> None:
    """One rank of phase 24's world (a spawned process): (a), then (b).
    Writes ``v2_rank<r>.pkl``."""
    import gc
    import pickle
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import kernels
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": V2_RANKS, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    hcg = fleet.get_hybrid_communicate_group()
    rank = dist.get_rank()
    kernels.reset_launch_counts()
    res = {"parity": _v2_parity_rank(rank, hcg, out_dir)}
    gc.collect()
    torch.cuda.empty_cache()
    res["fit"] = _v2_fit_rank(rank, smi)
    res["launches"] = {k["name"]: k["launches"] for k in kernels.kernels()}
    res["leaked"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "paddle_tpu"))
    res["backend"] = dist.ParallelEnv().backend
    with open(os.path.join(out_dir, f"v2_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _v2_world(smi: str) -> dict:
    """(a) and (b) in one four-rank world; returns the ranks' launches
    summed."""
    import pickle
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed.spawn_mod import spawn
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ref = _v2_reference(tmp)
        _log(f"vision2: (a) the one-process reference, ResNet-18 f32 "
             f"[{V2_PARITY_B}, 3, {V2_PARITY_HW}, {V2_PARITY_HW}]: losses "
             + " ".join(f"{v:.6f}" for v in ref)
             + f" ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        spawn("chip_smoke:_vision2_rank", args=(tmp, smi), nprocs=V2_RANKS)
        _log(f"vision2: the {V2_RANKS}-rank world took "
             f"{time.perf_counter() - t:.1f} s")
        ranks = []
        for r in range(V2_RANKS):
            with open(os.path.join(tmp, f"v2_rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        _v2_check(not res["leaked"], f"rank {r} imported {res['leaked'][:5]}")
        _v2_check(res["backend"] == "gloo", f"rank {r}: {res['backend']}")
        _v2_check(not any(res["launches"].values()),
                  f"vision2 rank {r}: launches {res['launches']}")
    # (a)
    par = [r["parity"] for r in ranks]
    p0 = par[0]
    rel = max(abs(a - b) / abs(b) for r in par
              for a, b in zip(r["losses"], p0["ref_losses"]))
    def fmt(e):
        return ("parameters worst " + ", ".join(
            f"{k} {v:.3e}" for k, v in e["params"])
            + f"; running statistics worst {e['stats'][0]} "
            f"{e['stats'][1]:.3e}; updates (L2) worst {e['update'][0]} "
            f"{e['update'][1]:.3e}")
    _log(f"vision2: (a) ResNet-18 f32 dp={V2_RANKS} on one card over gloo, "
         f"{V2_PARITY_STEPS} Momentum steps ({smi}): losses "
         + " ".join(f"{v:.6f}" for v in p0["losses"])
         + f" against one process's, largest relative difference {rel:.3e} "
         f"(tol {DIST_LOSS_TOL:g}); against it (largest difference over "
         f"the largest magnitude, floor {VISION_PARITY_FLOOR:g}) "
         + fmt(p0["dp"]) + "; the one-process run in NCHW against it: "
         + fmt(p0["nchw"]))
    _v2_check(all(r["groups"] == {1} for r in par),
              f"vision2 (a): BN data groups {[r['groups'] for r in par]}")
    _v2_check(rel <= DIST_LOSS_TOL, f"vision2 (a): losses differ by {rel}")
    for what in ("params", "stats"):
        worst = p0["dp"][what][0][1] if what == "params" \
            else p0["dp"][what][1]
        floor = p0["nchw"][what][0][1] if what == "params" \
            else p0["nchw"][what][1]
        _v2_check(worst <= max(VISION_PARITY_TOL, 2 * floor),
                  f"vision2 (a): {what} {p0['dp'][what]} beyond "
                  f"{max(VISION_PARITY_TOL, 2 * floor):.3e}")
    _v2_check(len({r["buffers"] for r in par}) == 1
              and len({r["params"] for r in par}) == 1,
              "vision2 (a): the ranks' states differ")
    # (b)
    fits = [r["fit"] for r in ranks]
    f0 = fits[0]
    n = V2_WARMUP + V2_TIMED
    timed = slice(V2_WARMUP, None)
    ms = [1e3 * float(np.median(f["times"][timed])) for f in fits]
    comm = [100 * float(np.median(np.asarray(f["comm"][timed])
                                  / np.asarray(f["times"][timed])))
            for f in fits]
    stats = [100 * float(np.median(np.asarray(f["stats"][timed])
                                   / np.asarray(f["times"][timed])))
             for f in fits]
    one = _R50_ONE_PROCESS.get("ms")
    _log(f"vision2: (b) BASELINE config 2 through Model.fit under "
         f"fleet.init: ResNet-50 dp={V2_RANKS} (four ranks on one card over "
         f"gloo), global batch {V2_B} ({V2_B // V2_RANKS} a rank), 224^2, "
         f"AMP O1, channels-last, {f0['sync_bns']} SyncBatchNorms, "
         f"Momentum(0.9) under CosineAnnealingDecay ({smi}): losses "
         + " ".join(f"{v:.4f}" for v in f0["losses"]) + "; lr "
         + " ".join(f"{v:.5f}" for v in f0["lrs"]))
    _log("vision2: (b) update ms by rank (median of the "
         f"{V2_TIMED} after {V2_WARMUP} warm-up) "
         + ", ".join(f"{v:.1f}" for v in ms)
         + f"; rank 0's updates " + " ".join(
             f"{1e3 * v:.1f}" for v in f0["times"])
         + f" ms; global {V2_B / (ms[0] / 1e3):.1f} img/s (rank 0); "
         "share of the update in collectives (host time) by rank "
         + ", ".join(f"{v:.1f}%" for v in comm)
         + ", of it the BN statistics collectives "
         + ", ".join(f"{v:.1f}%" for v in stats)
         + " and the gradient all-reduce the rest; peak memory by rank "
         + ", ".join(f"{f['peak'] / 2**30:.3f} GiB" for f in fits)
         + ("; one process at B=256 (phase 22 (b), channels-last) "
            f"{one:.3f} ms a step, {V2_B / (one / 1e3):.1f} img/s"
            if one else "; phase 22 did not run in this process"))
    _log("vision2: (b) rank 0's seconds in collectives over the fit by "
         "op/group: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
             f0["by_op"].items(), key=lambda kv: -kv[1]))
         + f"; of them in the BN statistics collectives "
         f"{sum(f0['stats']):.3f} s ({2 * f0['sync_bns']} a step)")
    _log(f"vision2: (b) evaluate on {V2_EVAL} images, every rank: "
         + "; ".join(f"loss {f['eval']['loss'][0]:.6f} acc "
                     f"{f['eval']['acc']:.4f}" for f in fits))
    _v2_check(all(f["steps"] == n + 1 for f in fits),
              f"vision2 (b): {[f['steps'] for f in fits]} updates")
    _v2_check(f0["sync_bns"] == 53 and all(f["cl"] for f in fits),
              "vision2 (b): SyncBatchNorms or channels-last missing")
    _v2_check(all(math.isfinite(v) for v in f0["losses"]),
              f"vision2 (b): losses {f0['losses']}")
    _v2_check(all(f["losses"] == f0["losses"] for f in fits),
              "vision2 (b): the ranks' losses differ")
    _v2_check(len({f["buffers"] for f in fits}) == 1,
              "vision2 (b): running statistics differ across the ranks")
    _v2_check(len({f["params"] for f in fits}) == 1,
              "vision2 (b): parameters differ across the ranks")
    _v2_check(all(f["eval"] == f0["eval"] for f in fits),
              "vision2 (b): evaluate differs across the ranks")
    _v2_check(f0["lrs"][0] > f0["lrs"][-1],
              f"vision2 (b): the schedule did not move: {f0['lrs']}")
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


def _v2_pool() -> None:
    """(c) max_pool2d(return_mask=True) then MaxUnPool2D at ResNet's stem
    (3x3, stride 2, pad 1 over [32, 64, 112, 112]), card against CPU."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(*V2_POOL_SHAPE, device="cuda", generator=g)
    unpool = nn.MaxUnPool2D(3, 2, 1, output_size=V2_POOL_SHAPE[2:])
    outs = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev)
        o, m = F.max_pool2d(xd, 3, 2, 1, return_mask=True)
        outs[dev] = (o.cpu(), m.cpu(), unpool(o, m).cpu())
    same = all(torch.equal(a, b) for a, b in zip(outs["cpu"], outs["cuda"]))
    pool_ms = _median_ms(lambda: F.max_pool2d(x, 3, 2, 1, return_mask=True),
                         iters=20, warmup=3)
    o, m = F.max_pool2d(x, 3, 2, 1, return_mask=True)
    unpool_ms = _median_ms(lambda: unpool(o, m), iters=20, warmup=3)
    _log(f"vision2: (c) max_pool2d(return_mask=True) -> MaxUnPool2D at "
         f"{list(V2_POOL_SHAPE)}: card equal to CPU (values, indices, "
         f"unpooled): {same}; {pool_ms:.4f} ms pool with indices, "
         f"{unpool_ms:.4f} ms unpool")
    _v2_check(same, "vision2 (c): the card's pool mask or unpool differs")


def _ssd300_priors(dev):
    """SSD300 on VOC: the six maps' priors (8732), Caffe order."""
    import torch
    from paddle_tpu_torch.vision import ops
    image = torch.empty(1, 3, 300, 300, device=dev)
    maps = [(38, 30.0, 60.0, [2.0], 8.0), (19, 60.0, 111.0, [2.0, 3.0], 16.0),
            (10, 111.0, 162.0, [2.0, 3.0], 32.0),
            (5, 162.0, 213.0, [2.0, 3.0], 64.0),
            (3, 213.0, 264.0, [2.0], 100.0), (1, 264.0, 315.0, [2.0], 300.0)]
    boxes, vars_ = [], []
    for size, mn, mx, ars, step in maps:
        feat = torch.empty(1, 1, size, size, device=dev)
        b, v = ops.prior_box(feat, image, [mn], [mx], ars, flip=True,
                             clip=True, steps=(step, step),
                             min_max_aspect_ratios_order=True)
        boxes.append(b.reshape(-1, 4))
        vars_.append(v.reshape(-1, 4))
    return torch.cat(boxes), torch.cat(vars_)


def _det_cases():
    """(d)'s ops at their published widths: (name, fn(dev) -> outputs,
    the float tolerance). Inputs from seeded numpy, distinct scores."""
    import numpy as np
    import torch
    from paddle_tpu_torch.vision import ops
    rng = np.random.default_rng(24)

    def t(a, dev):
        return torch.tensor(a, device=dev)

    def boxes(n, w, h, min_wh=4.0):
        xy = rng.uniform(0, 1, (n, 2)) * [w * 0.8, h * 0.8]
        wh = rng.uniform(0, 1, (n, 2)) * [w * 0.3, h * 0.3] + min_wh
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    # SSD300: decode 2 images' 8732 locations, then multiclass NMS
    loc = (rng.normal(size=(2, 8732, 4)) * 0.5).astype(np.float32)
    logits = rng.normal(size=(2, 21, 8732)).astype(np.float32) * 3
    conf = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)

    def ssd(dev):
        pb, pv = _ssd300_priors(dev)
        dec = ops.box_coder(pb, pv, t(loc, dev), "decode_center_size")
        out, cnt = ops.multiclass_nms(dec, t(conf.astype(np.float32), dev),
                                      0.01, 400, 200, 0.45)
        return pb, dec, out, cnt

    # YOLOv3-608: three heads, 80 classes
    heads = [(19, 32, [116, 90, 156, 198, 373, 326]),
             (38, 16, [30, 61, 62, 45, 59, 119]),
             (76, 8, [10, 13, 16, 30, 33, 23])]
    yx = [rng.normal(size=(2, 255, s, s)).astype(np.float32)
          for s, _, _ in heads]
    img = np.array([[608, 608], [608, 608]], np.int32)

    def yolo(dev):
        outs = []
        for (s, ds, anchors), x in zip(heads, yx):
            outs += list(ops.yolo_box(t(x, dev), t(img, dev), anchors, 80,
                                      0.005, ds))
        return outs

    # Mask R-CNN FPN: P2 at 800 x 1216, stride 4
    p2 = rng.normal(size=(2, 256, 200, 304)).astype(np.float32)
    box_rois = np.concatenate([boxes(512, 1216, 800) for _ in range(2)])
    mask_rois = np.concatenate([boxes(100, 1216, 800) for _ in range(2)])

    def roi_align(dev):
        f = t(p2, dev)
        return (ops.roi_align(f, t(box_rois, dev), t([512, 512], dev), 7,
                              0.25, 2, True),
                ops.roi_align(f, t(mask_rois, dev), t([100, 100], dev), 14,
                              0.25, 2, True))

    levels = [(200, 304, 32.0, 4.0), (100, 152, 64.0, 8.0),
              (50, 76, 128.0, 16.0), (25, 38, 256.0, 32.0),
              (13, 19, 512.0, 64.0)]

    def anchors(dev):
        return [ops.anchor_generator(torch.empty(1, 1, h, w, device=dev),
                                     [size], [0.5, 1.0, 2.0],
                                     stride=(st, st))[0]
                for h, w, size, st in levels]

    props = boxes(2000, 1216, 800, 2.0)
    lvl_scores = [(rng.permutation(2000).astype(np.float32) / 2000)[:, None]
                  for _ in range(4)]

    def fpn(dev):
        multi, restore, counts = ops.distribute_fpn_proposals(
            t(props, dev), 2, 5, 4, 224)
        rois, sc = ops.collect_fpn_proposals(
            multi, [t(v, dev) for v in lvl_scores], 2, 5, 1000, counts)
        return multi + [restore, counts, rois, sc]

    # R-FCN: 81 classes x 7 x 7 position-sensitive maps at stride 16
    rfcn = rng.normal(size=(2, 3969, 50, 76)).astype(np.float32)
    rfcn_rois = np.concatenate([boxes(300, 1216, 800) for _ in range(2)])

    def psroi(dev):
        return ops.psroi_pool(t(rfcn, dev), t(rfcn_rois, dev),
                              t([300, 300], dev), 7, 1.0 / 16)

    nms_boxes = boxes(1000, 1216, 800)
    nms_scores = rng.permutation(1000).astype(np.float32) / 1000

    def nms(dev):
        return ops.nms(t(nms_boxes, dev), 0.5, t(nms_scores, dev))

    # DCNv2 on res5's 3x3 conv
    dx = rng.normal(size=(2, 512, 25, 38)).astype(np.float32)
    doff = (rng.normal(size=(2, 18, 25, 38)) * 2).astype(np.float32)
    dmask = rng.uniform(size=(2, 9, 25, 38)).astype(np.float32)
    dw = (rng.normal(size=(512, 512, 3, 3)) * 0.02).astype(np.float32)

    def dcn(dev):
        return ops.deform_conv2d(t(dx, dev), t(doff, dev), t(dw, dev),
                                 padding=1, mask=t(dmask, dev))

    return [("ssd300 prior_box + box_coder + multiclass_nms", ssd, DET_TOL),
            ("yolov3-608 yolo_box x3", yolo, DET_TOL),
            ("mask-rcnn roi_align (7x7 and 14x14)", roi_align,
             DET_COORD_TOL),
            ("fpn anchor_generator P2-P6", anchors, DET_TOL),
            ("fpn distribute + collect", fpn, DET_TOL),
            ("r-fcn psroi_pool", psroi, DET_TOL),
            ("nms 1000 boxes", nms, DET_TOL),
            ("dcnv2 deform_conv2d res5", dcn, DET_SUM_TOL)]


def _v2_detection() -> None:
    """(d) every detection op at its published widths on the card against
    the port's own CPU run, each timed on the card (the median of three
    calls after one)."""
    import torch

    def flat(out):
        return list(out) if isinstance(out, (list, tuple)) else [out]

    for name, fn, tol in _det_cases():
        want = flat(fn("cpu"))
        got = flat(fn("cuda"))
        worst = 0.0
        for g, w in zip(got, want):
            g = g.cpu()
            if w.is_floating_point():
                _v2_check(g.shape == w.shape, f"vision2 (d) {name}: shape")
                worst = max(worst, _rel_err(g, w) if w.numel() else 0.0)
            else:
                _v2_check(torch.equal(g, w), f"vision2 (d) {name}: indices "
                          "or counts differ")
        ms = _median_ms(lambda: fn("cuda"), iters=3, warmup=1)
        _log(f"vision2: (d) {name}: {ms:.3f} ms on the card (inputs "
             f"copied in included), card within {worst:.3e} of the CPU "
             f"(tol {tol:g}); {len(got)} outputs")
        _v2_check(worst <= tol, f"vision2 (d) {name}: {worst} > {tol}")


def _v2_quant_conv() -> None:
    """(e) QuantizedConv2D forward and backward at a res3 3x3 conv
    ([8, 128, 28, 28], 128 -> 128), two training calls (the moving range
    moves), card against CPU."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import quant
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 128, 28, 28, generator=g)
    cot = torch.randn(8, 128, 28, 28, generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        conv = nn.Conv2D(128, 128, 3, padding=1, device="cpu")
        conv.reset_parameters(torch.Generator().manual_seed(6))
        qc = quant.QuantizedConv2D(conv).to(dev)
        outs = []
        for _ in range(2):
            xd = x.detach().to(dev).requires_grad_(True)
            out = qc(xd)
            (out * cot.to(dev)).sum().backward()
            outs += [out.detach().cpu(), xd.grad.cpu(),
                     conv.weight.grad.cpu()]
            conv.weight.grad = None
            conv.bias.grad = None
        res[dev] = (outs, float(qc._fq_a.scale))
    errs = [_rel_err(a, b) for a, b in zip(res["cuda"][0], res["cpu"][0])]
    _log(f"vision2: (e) QuantizedConv2D [8, 128, 28, 28] 3x3 128->128, two "
         f"calls: card against CPU out / dx / dw worst "
         + " / ".join(f"{max(errs[i::3]):.3e}" for i in range(3))
         + f" (tol {DET_TOL:g} / {DET_SUM_TOL:g} / {DET_SUM_TOL:g}); "
         f"activation scale {res['cuda'][1]:.6f} / {res['cpu'][1]:.6f}")
    _v2_check(max(errs[0::3]) <= DET_TOL and max(errs[1::3] + errs[2::3])
              <= DET_SUM_TOL, f"vision2 (e): {errs}")
    _v2_check(res["cuda"][1] == res["cpu"][1], "vision2 (e): scales differ")


def phase_vision2(smi: str) -> dict:
    """(a) ResNet-18 f32 at dp = 4 against one process, (b) BASELINE
    config 2 (ResNet-50) through Model.fit at dp = 4, O1, global BN
    statistics, (c) the pool mask and MaxUnPool2D, (d) the detection ops
    at published widths, (e) QuantizedConv2D; card against CPU for (c)-
    (e). Counts are set to 0 before (c) and in every rank before (a); no
    part launches a kernel of the port. Returns the phase's launches."""
    from paddle_tpu_torch.ops import kernels
    t = time.perf_counter()
    world = _v2_world(smi)
    _log(f"vision2: (a)-(b) took {time.perf_counter() - t:.1f} s")
    kernels.reset_launch_counts()
    for tag, fn in (("(c)", _v2_pool), ("(d)", _v2_detection),
                    ("(e)", _v2_quant_conv)):
        t = time.perf_counter()
        fn()
        _log(f"vision2: {tag} took {time.perf_counter() - t:.1f} s")
    got = _path_launches({}, "vision2 (c)-(e)")
    _require(not _V2_FAILS, "vision2: " + "; ".join(_V2_FAILS))
    return {"vision2": {k: world[k] + got[k] for k in got}}


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
    by_path.update(timed("distributed", phase_distributed, card["smi"]))
    by_path.update(timed("vision", phase_vision, card["smi"]))
    by_path.update(timed("moe", phase_moe, card["smi"]))
    by_path.update(timed("vision2", phase_vision2, card["smi"]))
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
