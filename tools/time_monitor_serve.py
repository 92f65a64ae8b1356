"""Time chip_smoke's f32 serving run with each monitor feature, in turns.

    python3 tools/time_monitor_serve.py [--reps 4]

From the root of a checkout, on a machine with one CUDA card. Builds
phase 3's engine (``gpt2_medium``, f32, random weights from seed 0) and
runs its 16 greedy requests with the monitor flags off, with
``FLAGS_trace`` (sample 1.0), ``FLAGS_monitor``, ``FLAGS_flight_recorder``
alone, and all of them together on a second engine built with the admin
plane (``FLAGS_monitor_port`` on an ephemeral 127.0.0.1 port) and an
availability SLO, which also runs with the flags off; no chaos, so every run serves the same requests. The
configurations run in turns, forward then in reverse, ``--reps`` times,
after one warm run an engine. Prints the card's name and power limit
(chip_smoke's phase 1, which also builds the kernels), then each
configuration's decode-step p50 per run and over all its decode steps,
and its tokens/s per run.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# (name, flags, engine): "plain" built with the flags off, "admin" with
# the admin plane and an SLO; "off@admin" tells the second engine's own
# speed from its flags'
CONFIGS = (
    ("off", {}, "plain"),
    ("trace", {"trace": True, "trace_sample": 1.0}, "plain"),
    ("monitor", {"monitor": True}, "plain"),
    ("flight_recorder", {"flight_recorder": True}, "plain"),
    ("all", dict(chip_smoke.MONITOR_SERVE_FLAGS), "admin"),
    ("off@admin", {}, "admin"),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_monitor_serve.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium
    from paddle_tpu_torch.monitor import server
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    chip_smoke.phase_card()
    cfg = gpt2_medium()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    plain = ServingEngine(model, ServingConfig(**chip_smoke.SERVE_CFG),
                          device="cuda")
    with chip_smoke._flags(chip_smoke.MONITOR_SERVE_FLAGS):
        admin = ServingEngine(model, ServingConfig(
            slo_availability=0.99, **chip_smoke.SERVE_CFG), device="cuda")
    specs = chip_smoke._slice_specs(cfg.vocab_size)
    engines = {"plain": plain, "admin": admin}
    for eng in (plain, admin):
        eng.warmup()
        chip_smoke._monitor_serve_run(eng, specs, False)
    out = {name: [] for name, _, _ in CONFIGS}
    for rep in range(args.reps):
        order = CONFIGS if rep % 2 == 0 else CONFIGS[::-1]
        for name, flags, eng in order:
            with chip_smoke._flags(flags):
                run = chip_smoke._monitor_serve_run(engines[eng], specs,
                                                    False)
            _require_completed(run[0])
            out[name].append((run[1], run[5]))
    for name, runs in out.items():
        pooled = np.concatenate([r[1] for r in runs])
        print(f"{name}: decode p50 " + ", ".join(
            f"{r[0]['decode_step_p50_s'] * 1e3:.3f}" for r in runs)
            + f" ms; over all {len(pooled)} steps p50 "
            f"{np.percentile(pooled, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(pooled, 99) * 1e3:.3f} ms; tokens/s "
            + ", ".join(f"{r[0]['tokens_per_sec']:.2f}" for r in runs),
            flush=True)
    plain.shutdown()
    admin.shutdown()
    server.stop_server()
    return 0


def _require_completed(states) -> None:
    bad = [st.outcome for st in states if st.outcome != "completed"]
    if bad:
        raise RuntimeError(f"requests ended {bad}")


if __name__ == "__main__":
    sys.exit(main())
