"""Device time of the port's no-bias flash backward at GPT-2 345M's
training shape (B=8, S=1024, H=16, D=64, bf16, causal, dropout 0.1),
the ``flash_attention_bwd`` entry of ``paddle_tpu_torch/csrc/
flash_attention_bwd.cu``.

Run it from the root of the checkout whose kernel it should time (it
imports ``paddle_tpu_torch`` from the working directory). Prints one
JSON line: the card's name and power limit as ``nvidia-smi`` reports
them, the median of ``--reps`` launches each timed by its own pair of
CUDA events, a checksum of the gradients, and the checkout's directory
name. To compare two versions of the source, run it from both checkouts
in one session on the same card, in the order A, B, B, A::

    python3 tools/time_flash_bwd.py --reps 50
    (cd ../other_checkout && python3 ../repo/tools/time_flash_bwd.py)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    B, S, H, D, rate, words = 8, 1024, 16, 64, 0.1, (0x2468ACE0, 0x13579BDF)
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, True, None, True, rate, words)

    def run():
        return flash_attention_bwd(q, k, v, o, lse, do, True, None, rate,
                                   words)
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(args.reps):
        # the card spins first, so the launch is queued before the start
        torch.cuda._sleep(200_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        run()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    dq, dk, dv = run()
    print(json.dumps({
        "card": smi.strip().splitlines()[0],
        "shape": f"B={B} S={S} H={H} D={D} bfloat16 causal dropout {rate}",
        "median_ms": times[len(times) // 2], "min_ms": times[0],
        "reps": args.reps,
        "checksum": [float(t.float().abs().sum()) for t in (dq, dk, dv)],
        "checkout": os.path.basename(os.getcwd())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
