"""Run chip_smoke.py's card phase and one later phase alone.

    python3 tools/run_chip_phase.py monitor|fleet|distributed

From the root of a checkout, on a machine with one CUDA card: builds the
kernels (phase 1), then drives the named phase and prints its launches:
``monitor`` is phase 18 (the monitor plane on the f32 serving path and
the DataLoader-fed BERT-base training path), ``fleet`` phase 20
(``generate`` and beam search over static caches, the fleet router with
fleet monitoring and a kill drill, weight pushes under load),
``distributed`` phase 21 (the kernels' dropout base offsets, NCCL at
world size 1, a four-rank gloo world's parity and timed runs). Exits
non-zero if a check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PHASES = {"monitor": lambda card: chip_smoke.phase_monitor(),
          "fleet": lambda card: chip_smoke.phase_fleet(),
          "distributed": lambda card: chip_smoke.phase_distributed(
              card["smi"])}


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in PHASES:
        print(f"usage: run_chip_phase.py {'|'.join(PHASES)}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("run_chip_phase.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = chip_smoke.phase_card()
    t = time.perf_counter()
    out = PHASES[sys.argv[1]](card)
    print(f"{sys.argv[1]}: phase took {time.perf_counter() - t:.1f} s")
    print(out)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
