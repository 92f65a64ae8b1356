#!/usr/bin/env python3
"""Time the decode-step kernels of the checkout it runs from.

Holds the paged-decode kernels (rows 9 and 10 of ``PERF.md``'s kernel
table: float32 and int8 pools) and the bgmv kernel (row 11) against
their plain versions and times them, at the shapes of ``chip_smoke.py``'s
phase 2 (its own case functions): decode at B=8, MB=32, bs=16, H=16,
D=64, P=257 with the L2 cache flushed before every launch; bgmv at the
decode (B=8, S=1) and prefill (B=4, S=256) dispatches, E=1024, r=8,
O=3072, float32 and bfloat16. It builds and imports the package and the
``chip_smoke.py`` found in the working directory, so two versions of a
source compare on one card by running it from each tree's root in one
call, A, B, B, A::

    python3 tools/time_torch_mt_kernels.py
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_torch_mt_kernels.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import kernels
    kernels.build(["paged_decode_attention", "paged_decode_attention_quant",
                   "bgmv"])
    print(f"tree: {os.getcwd()}; card: {torch.cuda.get_device_name(0)}")
    rows = {"paged_decode_attention": smoke._paged_case(torch.float32, 1,
                                                        timed=True),
            "paged_decode_attention_quant": smoke._quant_paged_case(
                2, timed=True)}
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, ids in ((8, 1, [0, 1, 2, 3, 0, 5, 8, 8]),
                          (4, 256, [3, 0, 7, 3])):
            rows[f"bgmv B={B} S={S} {smoke._name(dtype)}"] = \
                smoke._bgmv_case(B, S, dtype, ids, timed=True)
    for name, r in rows.items():
        print(json.dumps({"name": name, "ms": r["ms"],
                          "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
