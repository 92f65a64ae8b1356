#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one NVIDIA card.

Serves the same 16 greedy requests as ``chip_smoke.py`` (GPT-2 345M with
seeded random weights, the ``bench.py --serve`` full configuration)
through ``paddle_tpu_torch.serving.ServingEngine`` under
``torch.profiler`` -- or, with ``--mt``, the 24 requests of
``chip_smoke.py``'s multi-tenant phase through its engine (int8 paged KV,
eight LoRA adapters, tenant quota 4), submitted at once -- and prints:

- the host wall time of the run, with and without the profiler, the
  device's busy and idle share (summed kernel time over the profiled
  wall time; one stream, so kernels never overlap) and the kernel
  launches per dispatch;
- device time by kernel, the top rows of ``key_averages()``;
- host time by operator, the top rows by self CPU time;
- the launches of each hand-written kernel in the profiled run.

Run from the root of a checkout::

    python3 tools/profile_torch_serve.py [--rows 15] [--mt]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=15,
                    help="rows of each table")
    ap.add_argument("--mt", action="store_true",
                    help="profile the multi-tenant engine and traffic")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (LoadSpec, Request, SamplingParams,
                                          ServingConfig, ServingEngine,
                                          build_requests)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = gpt2_medium()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    if args.mt:
        engine = smoke._mt_engine(model, True)
    else:
        engine = ServingEngine(model, ServingConfig(**smoke.SERVE_CFG),
                               device="cuda")
    engine.warmup()

    def mt_requests(seed):
        # seed 23 is the phase's traffic; the warm-up pass takes another
        spec = dict(smoke.MT_SPEC, seed=smoke.MT_SPEC["seed"] + seed)
        return [r for _, r in build_requests(LoadSpec(**spec))]

    def requests(seed):
        if args.mt:
            return mt_requests(seed)
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(smoke.NUM_REQUESTS):
            n = int(rng.randint(smoke.PROMPT_RANGE[0],
                                smoke.PROMPT_RANGE[1] + 1))
            new = int(rng.randint(smoke.NEW_TOKENS_RANGE[0],
                                  smoke.NEW_TOKENS_RANGE[1] + 1))
            out.append(Request(rng.randint(0, cfg.vocab_size, (n,)),
                               max_new_tokens=new,
                               sampling=SamplingParams()))
        return out

    # one unprofiled pass first: library handles and allocator pools
    for r in requests(1):
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for r in requests(0):
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0

    steps0 = engine.stats()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in requests(0):
            engine.submit(r)
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = {k: engine.stats()[k] - steps0[k]
             for k in ("prefill_dispatches", "decode_dispatches",
                       "tokens_generated")}

    avgs = prof.key_averages()
    # kernels only: an operator's device time repeats its kernels'
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                 key=lambda a: -a.self_device_time_total)
    busy = sum(a.self_device_time_total for a in dev) / 1e6   # us -> s
    # cudaLaunchKernelExC: the cluster launches of the paged-decode kernel
    n_launch = sum(a.count for a in avgs
                   if a.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    n_disp = steps["prefill_dispatches"] + steps["decode_dispatches"]
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"run: {wall:.4f} s wall under the profiler ({bare:.4f} s "
          f"without), {steps['tokens_generated']} tokens, "
          f"{steps['prefill_dispatches']} prefill and "
          f"{steps['decode_dispatches']} decode dispatches")
    print(f"device: busy {busy:.4f} s = {100 * busy / wall:.2f}% of the "
          f"profiled wall, idle {100 * (1 - busy / wall):.2f}%; "
          f"{n_launch} kernel launches, {n_launch / n_disp:.1f} per "
          f"dispatch")
    print(f"\ndevice time by kernel (top {args.rows}):")
    print(f"{'ms':>10} {'%busy':>7} {'calls':>7}  name")
    for a in dev[:args.rows]:
        ms = a.self_device_time_total / 1e3
        print(f"{ms:10.3f} {100 * ms / 1e3 / busy:7.2f} {a.count:7d}  "
              f"{a.key[:90]}")
    print(f"\nhand-written kernel launches in the profiled run "
          f"({n_disp} dispatches):")
    for k in kernels.kernels():
        if k["launches"]:
            print(f"{k['launches']:7d} {k['launches'] / n_disp:7.2f} per "
                  f"dispatch  {k['name']}")
    host = sorted(avgs, key=lambda a: -a.self_cpu_time_total)
    print(f"\nhost time by operator, self (top {args.rows}):")
    print(f"{'ms':>10} {'%wall':>7} {'calls':>7}  name")
    for a in host[:args.rows]:
        ms = a.self_cpu_time_total / 1e3
        print(f"{ms:10.3f} {100 * ms / 1e3 / wall:7.2f} {a.count:7d}  "
              f"{a.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
