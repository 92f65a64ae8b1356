#!/usr/bin/env python3
"""What bounds the paged-decode kernels on the card: time variants of
``paddle_tpu_torch/csrc/paged_decode.cu``.

Each variant is the checkout's source with one change made by text
substitution: 8 or 16 positions a warp step instead of 4 (``step8``,
``step16``), no scale loads in the int8 kernel (``noscale``: its output
is wrong and is not checked), the block size fixed at 16 when compiled,
so no integer division (``bs16``), 4 warps a block instead of 8
(``warps4``). Every variant is built with the repository's ``nvcc``
flags into ``paddle_tpu_torch/_build/variants/`` and both of its entries
are timed at ``chip_smoke.py``'s row-9/row-10 shape (B=8, MB=32, bs=16,
H=16, D=64, P=257, 1057 visible positions): the int8 kernel with the L2
cache flushed before every launch and warm, the float32 kernel flushed.
Two rounds, so the spread shows. Run from the root of a checkout::

    python3 tools/time_torch_decode_variants.py
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def variants(src: str) -> dict:
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"variant anchor not in the source: {old!r}")
        return text.replace(old, new)
    return {
        "base": src,
        "step8": sub(src, "constexpr int STEP = 4;",
                     "constexpr int STEP = 8;"),
        "step16": sub(src, "constexpr int STEP = 4;",
                      "constexpr int STEP = 16;"),
        "noscale": sub(sub(src, "ks[srow], kv[u]", "1.f, kv[u]"),
                       "vs[srow], vv[u]", "1.f, vv[u]"),
        "bs16": sub(src, "int H, int bs, int MB, float scale) {\n",
                    "int H, int bs_, int MB, float scale) {\n"
                    "  constexpr int bs = 16;\n"),
        "warps4": sub(src, "constexpr int WARPS = 8;",
                      "constexpr int WARPS = 4;"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_torch_decode_variants.py: no CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving.kv_cache import write_pages_quant
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    src = (kernels.CSRC_DIR / "paged_decode.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC_DIR), "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        q8, f32 = lib.paged_decode_attention_quant, lib.paged_decode_attention
        q8.argtypes = kernels.PAGED_DECODE_QUANT.argtypes
        f32.argtypes = kernels.PAGED_DECODE.argtypes
        q8.restype = f32.restype = ctypes.c_int
        fns[name] = (q8, f32)

    B, MB, bs, H, D, P = 8, 32, 16, 16, 64, 257
    g = torch.Generator(device="cuda").manual_seed(2)
    every = torch.arange(P, dtype=torch.int32, device="cuda")[None]
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    pools = []
    for _ in range(2):
        pages = torch.zeros(P, bs, H, D, dtype=torch.int8, device="cuda")
        scales = torch.zeros(P, bs, H, device="cuda")
        write_pages_quant(pages, scales, torch.randn(
            1, P * bs, H, D, device="cuda", generator=g), every, start)
        pools.append((pages, scales))
    (kp, ks), (vp, vs) = pools
    kf, vf = (torch.randn(P, bs, H, D, device="cuda", generator=g)
              for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g)
    pos = np.array([0, 0, 7, 15, 16, 200, 300, 511], np.int32)
    perm = np.random.RandomState(2).permutation(np.arange(1, P))
    table = np.zeros((B, MB), np.int32)
    used = 0
    for b in range(1, B):
        n = int(pos[b]) // bs + 1
        table[b, :n] = perm[used:used + n]
        used += n
    tbl, pos_t = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
    out = torch.empty_like(q)
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    print(f"card: {torch.cuda.get_device_name(0)}")
    for rnd in range(2):
        for name, (q8, f32) in fns.items():
            def int8():
                q8(q.data_ptr(), kp.data_ptr(), ks.data_ptr(), vp.data_ptr(),
                   vs.data_ptr(), tbl.data_ptr(), pos_t.data_ptr(),
                   out.data_ptr(), B, H, D, bs, MB, scale, stream)

            def full():
                f32(q.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                    tbl.data_ptr(), pos_t.data_ptr(), out.data_ptr(), B, H,
                    D, bs, MB, scale, 0, stream)
            cold = smoke._median_ms(int8, flush=scrub.zero_)
            warm = smoke._median_ms(int8)
            f32_ms = smoke._median_ms(full, flush=scrub.zero_)
            print(f"round {rnd} {name:8s} int8 {cold:.4f} ms (L2 warm "
                  f"{warm:.4f}), float32 {f32_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
