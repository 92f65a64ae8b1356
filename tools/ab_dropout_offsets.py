"""Rows 1-5 and 8 of one checkout against another's, on one card: bits
and device time.

    python3 tools/ab_dropout_offsets.py OTHER_CHECKOUT

Run from the root of a checkout, on a machine with one CUDA card. For
each checkout in the order this, other, other, this, a fresh process
imports that checkout's ``paddle_tpu_torch`` (building its kernels into
its own ``_build``), runs the flash forward and backward (rows 1 and 3)
and the fused dropout (row 8) at GPT-2 345M's training shapes (B=8,
S=1024, H=16, D=64, causal, dropout 0.1; dropout on [8, 1024, 1024]),
and the biased flash forward, dq and dk/dv/dbias (rows 2, 4, 5) at
BERT-base's padded batch (B=48, S=512, H=12, D=64, 7 rows padded,
dropout 0.1), in bfloat16 and float32 from the same seeded inputs and
seed words, saves
every output, and times each launch as the median of ``--reps`` launches
(each between its own pair of CUDA events). Both checkouts are driven
through the wrappers' arguments they share, so a checkout whose kernels
take base offsets runs them at their default, 0. The script then
requires every output of every run to equal the first run's bit for
bit, and prints the card's name and power limit and each run's times
in one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _measure(out_path: str, reps: int) -> dict:
    """In the checkout at the working directory: every output to
    ``out_path`` and the median times (ms)."""
    sys.path.insert(0, os.getcwd())
    import torch
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.dropout import dropout_apply
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bias_bwd_dkv, flash_attention_bias_bwd_dq,
        flash_attention_bias_fwd, flash_attention_bwd, flash_attention_fwd)
    kernels.build()
    sys.path.insert(0, ROOT)
    from chip_smoke import _median_ms
    words, rate = (0x2468ACE0, 0x13579BDF), 0.1
    outs, times = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device="cuda").manual_seed(9)
        q, k, v, do = (torch.randn(8, 1024, 16, 64, device="cuda",
                                   generator=g).to(dtype)
                       for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, True, None, True, rate, words)
        grads = flash_attention_bwd(q, k, v, o, lse, do, True, None, rate,
                                    words)
        outs[f"fwd {name}"] = (o.cpu(), lse.cpu())
        outs[f"bwd {name}"] = tuple(t.cpu() for t in grads)
        times[f"row 1 {name}"] = _median_ms(lambda: flash_attention_fwd(
            q, k, v, True, None, True, rate, words), iters=reps)
        times[f"row 3 {name}"] = _median_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, True, None, rate, words), iters=reps)
        x = torch.randn(8, 1024, 1024, device="cuda", generator=g).to(dtype)
        outs[f"dropout {name}"] = (dropout_apply(x, rate, words).cpu(),)
        times[f"row 8 {name}"] = _median_ms(
            lambda: dropout_apply(x, rate, words), iters=reps)
        del q, k, v, do, o, lse, grads, x
        q, k, v, do = (torch.randn(48, 512, 12, 64, device="cuda",
                                   generator=g).to(dtype)
                       for _ in range(4))
        bias = torch.zeros(48, 512, device="cuda")
        for b in range(7):
            bias[b, 256 + 32 * b:] = -1e30
        o, lse = flash_attention_bias_fwd(q, k, v, bias, False, None, True,
                                          rate, words)
        args = (q, k, v, bias, o, lse, do, False, None, rate, words)
        outs[f"bias fwd {name}"] = (o.cpu(), lse.cpu())
        outs[f"bias bwd {name}"] = (
            flash_attention_bias_bwd_dq(*args).cpu(),
            *(t.cpu() for t in flash_attention_bias_bwd_dkv(*args)))
        times[f"row 2 {name}"] = _median_ms(
            lambda: flash_attention_bias_fwd(q, k, v, bias, False, None,
                                             True, rate, words), iters=reps)
        times[f"row 4 {name}"] = _median_ms(
            lambda: flash_attention_bias_bwd_dq(*args), iters=reps)
        times[f"row 5 {name}"] = _median_ms(
            lambda: flash_attention_bias_bwd_dkv(*args), iters=reps)
        del q, k, v, do, o, lse, args
    torch.save(outs, out_path)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(_measure(args.measure, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available() or not args.other:
        print("ab_dropout_offsets.py: needs a CUDA device and the other "
              "checkout", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    other = os.path.abspath(args.other)
    order = ((ROOT, "this"), (other, "other"), (other, "other"),
             (ROOT, "this"))
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, (tree, tag) in enumerate(order):
            path = os.path.join(tmp, f"run{i}.pt")
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure",
                 path, "--reps", str(args.reps)], cwd=tree,
                capture_output=True, text=True)
            if r.returncode:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            times = json.loads(r.stdout.strip().splitlines()[-1])
            print(json.dumps({"run": i, "checkout": tag, "card": smi,
                              "ms": times}), flush=True)
            paths.append(path)
        first = torch.load(paths[0])
        for p in paths[1:]:
            got = torch.load(p)
            for key, tensors in first.items():
                for a, b in zip(tensors, got[key]):
                    if not torch.equal(a.view(torch.int16)
                                       if a.dtype == torch.bfloat16
                                       else a.view(torch.int32),
                                       b.view(torch.int16)
                                       if b.dtype == torch.bfloat16
                                       else b.view(torch.int32)):
                        print(f"{key}: outputs differ between runs",
                              file=sys.stderr)
                        return 1
    print(f"all {len(first)} outputs bit-equal across the four runs "
          f"({', '.join(first)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
