"""Run chip_smoke.py's card phase and its monitor phase alone.

    python3 tools/run_monitor_phase.py

From the root of a checkout, on a machine with one CUDA card: builds the
kernels (phase 1), then drives phase 18 (the monitor plane on the f32
serving path and the DataLoader-fed BERT-base training path) and prints
its launches. Exits non-zero if a check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("run_monitor_phase.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    chip_smoke.phase_card()
    serve, train = chip_smoke.phase_monitor()
    print({"monitor_serve": serve, "monitor_train": train})
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
