"""Time chip_smoke's f32 serving run with the dispatch watchdog off and
armed, in turns, and with variants of the guarded dispatch.

    python3 tools/time_watchdog_dispatch.py [--reps 3]

From the root of a checkout, on a machine with one CUDA card. Builds
phase 3's engine (``gpt2_medium``, f32, random weights from seed 0) and
runs its 16 greedy requests ``--reps`` times in each of the orders off,
armed, armed, off, after one warm run. "armed" sets
``FLAGS_serve_watchdog_s`` to 5 s: every dispatch runs on the engine's
worker thread. Then the same turns for two variants that tell the parts
of the armed path apart: ``same-thread`` runs the guarded job on the
calling thread through the same gate and contexts (no handoff), and
``no-stream`` runs it on the worker without entering the caller's
stream. Every run must give the off run's tokens. Prints the card's name
and power limit (chip_smoke's phase 1, which also builds the kernels),
the Python threads alive, then each mode's decode-step p50 per run and
over all its decode steps, and one empty guarded dispatch's cost.
"""

import argparse
import contextlib
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving import engine as engine_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_card()
    print("python threads:", [t.name for t in threading.enumerate()],
          f"; {os.cpu_count()} CPUs, affinity "
          f"{len(os.sched_getaffinity(0))}", flush=True)
    cfg = gpt2_medium()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    eng = ServingEngine(model, ServingConfig(**chip_smoke.SERVE_CFG),
                        device="cuda")
    eng.warmup()
    specs = chip_smoke._slice_specs(cfg.vocab_size)
    ref = [st.generated for st in chip_smoke._res_serve(eng, specs)[0]]

    real_dispatch = engine_mod.DispatchWorker.dispatch

    def same_thread(self, fn, timeout_s):
        return {"value": fn()}

    modes = {
        "off": (0.0, contextlib.nullcontext),
        "armed": (5.0, contextlib.nullcontext),
        "same-thread": (5.0, lambda: _patched(
            engine_mod.DispatchWorker, "dispatch", same_thread)),
        "no-stream": (5.0, lambda: _patched(
            torch.cuda, "stream", lambda s: contextlib.nullcontext())),
    }
    steps = {m: [] for m in modes}
    per_run = {m: [] for m in modes}
    for pair in (("off", "armed"), ("off", "same-thread"),
                 ("off", "no-stream")):
        a, b = pair
        for _ in range(args.reps):
            for mode in (a, b, b, a):
                budget, ctx = modes[mode]
                with flag_scope("serve_watchdog_s", budget), ctx():
                    sts, dt = chip_smoke._res_serve(eng, specs)
                assert [st.generated for st in sts] == ref, mode
                steps[mode] += dt
                per_run[mode].append(float(np.percentile(dt, 50)) * 1e3)
    assert engine_mod.DispatchWorker.dispatch is real_dispatch
    for mode in modes:
        print(f"{mode:>12}: decode p50 over {len(steps[mode])} steps "
              f"{float(np.percentile(steps[mode], 50)) * 1e3:.3f} ms; runs "
              + ", ".join(f"{x:.3f}" for x in per_run[mode]), flush=True)
    off_us, armed_us = chip_smoke._res_guard_us(eng)
    print(f"one guarded dispatch of an empty job: {off_us:.2f} us off, "
          f"{armed_us:.2f} us armed", flush=True)
    eng.shutdown()
    return 0


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


if __name__ == "__main__":
    sys.exit(main())
