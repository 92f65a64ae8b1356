#!/usr/bin/env python3
"""Choose the paged-decode kernels' schedule on the card: time variants
of ``paddle_tpu_torch/csrc/paged_decode.cu``.

Each variant is the checkout's source with its schedule constants
changed by text substitution: the blocks of a (slot, head)'s cluster
(``CLUSTER``), the warps a block (``WARPS``) and the row loads a lane
keeps in flight (``STEPS``); variant ``cCwWsS`` sets them to C, W and S,
``base`` is the source as it is. A cluster of 1 is one block per (slot,
head), the wider-block design. Every variant is built with the
repository's ``nvcc`` flags into ``paddle_tpu_torch/_build/variants/``
(one process each, all at once), both of its entries
are checked against their plain versions (max abs error 1e-4) and
timed at ``chip_smoke.py``'s row-9/row-10 shape (B=8, MB=32, bs=16,
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

# (CLUSTER, WARPS, STEPS) of each variant
SCHEDULES = ((1, 8, 4), (1, 16, 4), (2, 4, 4), (2, 8, 4), (4, 2, 4),
             (4, 4, 2), (4, 4, 4), (4, 8, 4), (8, 2, 4), (8, 4, 4),
             (16, 4, 4))


def variants(src: str) -> dict:
    def sub(text, name, value):
        old = f"constexpr int {name} = "
        start = text.index(old) + len(old)   # raises if the anchor is gone
        end = text.index(";", start)
        return text[:start] + str(value) + text[end:]
    out = {"base": src}
    for c, w, s in SCHEDULES:
        out[f"c{c}w{w}s{s}"] = sub(sub(sub(src, "CLUSTER", c), "WARPS", w),
                                   "STEPS", s)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_torch_decode_variants.py: no CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_plain, paged_decode_quant_plain)
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
    ref8 = paged_decode_quant_plain(q, kp, ks, vp, vs, tbl, pos_t, scale)
    ref32 = paged_decode_plain(q, kf, vf, tbl, pos_t, scale)

    def calls(q8, f32):
        def int8():
            return q8(q.data_ptr(), kp.data_ptr(), ks.data_ptr(),
                      vp.data_ptr(), vs.data_ptr(), tbl.data_ptr(),
                      pos_t.data_ptr(), out.data_ptr(), B, H, D, bs, MB,
                      scale, stream)

        def full():
            return f32(q.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                       tbl.data_ptr(), pos_t.data_ptr(), out.data_ptr(), B,
                       H, D, bs, MB, scale, 0, stream)
        return int8, full

    for name in list(fns):
        errs = []
        for call, ref in zip(calls(*fns[name]), (ref8, ref32)):
            out.zero_()
            err = call()
            torch.cuda.synchronize()
            errs.append(float("inf") if err else
                        (out - ref).abs().max().item())
        print(f"{name:9s} max|o-plain| int8 {errs[0]:.3e}, float32 "
              f"{errs[1]:.3e}")
        if not max(errs) <= 1e-4:
            print(f"{name:9s} did not launch or disagrees: left out")
            del fns[name]
    for rnd in range(2):
        for name, lib_fns in fns.items():
            int8, full = calls(*lib_fns)
            cold = smoke._median_ms(int8, flush=scrub.zero_)
            warm = smoke._median_ms(int8)
            f32_ms = smoke._median_ms(full, flush=scrub.zero_)
            print(f"round {rnd} {name:9s} int8 {cold:.4f} ms (L2 warm "
                  f"{warm:.4f}), float32 {f32_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
