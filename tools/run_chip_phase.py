"""Run chip_smoke.py's card phase and one later phase alone.

    python3 tools/run_chip_phase.py monitor|fleet|distributed|vision|moe|vision2|recsys|tp_serve|eager

From the root of a checkout, on a machine with one CUDA card: builds the
kernels (phase 1), then drives the named phase and prints its launches:
``monitor`` is phase 18 (the monitor plane on the f32 serving path and
the DataLoader-fed BERT-base training path), ``fleet`` phase 20
(``generate`` and beam search over static caches, the fleet router with
fleet monitoring and a kill drill, weight pushes under load),
``distributed`` phase 21 (the kernels' dropout base offsets, NCCL at
world size 1, a four-rank gloo world's parity and timed runs over dp x
mp, then the pipeline's: the point-to-point probe, the f32 pipeline
parity at pp x mp and pp = 4 under both schedules, BASELINE config 4 at
pp = 2 x mp = 2; then sequence parallelism (ring and Ulysses attention,
the sequence-parallel GPT's parity), BASELINE config 5 (ERNIE-3.0 1.5B
at sharding = 2 x mp = 2) and the resharding checkpoint), ``vision``
phase 22 (BASELINE config 1, LeNet eager; config 2, ResNet-50 through
``TrainStep`` at AMP O1, channels-last and not; ResNet-18 f32 on the
card against the CPU and the TF32 gap; VGG-16 with its dropouts through
the fused dropout kernel; ``fold_conv_bn``), ``moe`` phase 23 (GPT-2
345M-8E through ``TrainStep`` at AMP O1, sort against einsum, ``generate``
and the serving engine over it, ep = 4 over four ranks on the card),
``vision2`` phase 24 (ResNet-18 f32 at dp = 4 against one process and
BASELINE config 2's ResNet-50 through ``hapi.Model.fit`` at dp = 4 over
four ranks on the card, with BatchNorm statistics over the global batch;
the pool mask and ``MaxUnPool2D``, the detection ops at their published
widths and ``QuantizedConv2D``, card against CPU), ``recsys`` phase 25
(``bench.py --recsys``'s dedup parity; DLRM ``dlrm_criteo_small``
trained through tiered tables, then against the CPU, and ranked by
``RecsysEngine``; ``ShardedEmbeddingTable`` at full vocab in one process
and over a ps = 2 world on the card; the native PS server built from
the port's source), ``tp_serve`` phase 26 (GPT-2 345M served
tensor-parallel at mp = 2 by two ranks on the card, f32 and int8 pools,
against one process; the MoE GPT's step at mp = 2; ``run_elastic``
resuming a killed training loop), ``eager`` phase 27 (GPT-2 345M trained
three steps by the eager loop of the Paddle API against ``TrainStep``
from the same weights, bit for bit; the facade's host cost a call; the
public ``F.scaled_dot_product_attention`` on facades against the direct
call).
Exits non-zero if a check fails.
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
              card["smi"]),
          "vision": lambda card: chip_smoke.phase_vision(card["smi"]),
          "moe": lambda card: chip_smoke.phase_moe(card["smi"]),
          "vision2": lambda card: chip_smoke.phase_vision2(card["smi"]),
          "recsys": lambda card: chip_smoke.phase_recsys(card["smi"]),
          "tp_serve": lambda card: chip_smoke.phase_tp_serve(card["smi"]),
          "eager": lambda card: chip_smoke.phase_eager(card["smi"])}


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
