#!/usr/bin/env python3
"""Time the float32 flash forward on the card: the 3xTF32 tensor-core
kernel of ``paddle_tpu_torch/csrc/flash_attention_fwd.cu`` and variants
of its split, an older tree's source beside it, and SDPA.

Variants are the checkout's source (``base``) and, by text
substitution: ``b3`` (``F32_MIN_BLOCKS_64``, the blocks an SM that
``__launch_bounds__`` asks for at D = 64, set to 3); ``k64_b2`` (64-key
tiles, ``F32_BK``, at 2 blocks an SM); ``cvt`` (the split's tf32
rounding by ``cvt.rna.tf32.f32`` instead of its integer form) and
``two_mma`` (the small_a . big_b product dropped: wrong by about 2^-11
and failing the check, timed only to show what one tensor-core product
in three costs);
``--also NAME=PATH`` adds the flash forward source at PATH (an older
tree's, with the same C entries) as variant NAME. Every variant is built with
the repository's ``nvcc`` flags into ``paddle_tpu_torch/_build/
variants/`` (one process each, all at once; the ptxas register and
spill lines of its f32 kernels at D = 64 printed), checked against the plain
version (o within chip_smoke.py's TOL["float32"], lse within 1e-5) and
timed, two rounds, at the shapes of the f32 paths:

- serve: GPT-2 345M's prefill, B=4, S=256, H=16, D=64, causal;
- bert: BERT-base's padded batch (chip_smoke.py's pretraining_batch),
  B=48, S=512, H=12, D=64, the f32 -1e30 key bias, without dropout (the
  predictor) and with rate 0.1 (training's).

SDPA in float32 (the float mask for bert) is timed beside them, and the
device kernels one SDPA call runs are named from a profile. First, the
TFLOP/s that mma.sync m16n8k8 tf32 sustains alone (8 independent
products a warp a step, 4 and 16 warps an SM) gives the ceiling of a
3xTF32 kernel built on it. Run from the
root of a checkout::

    python3 tools/time_torch_flash_f32.py [--also was=OLD/flash_attention_fwd.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = (0x0BADF00D, 0x5EED5EED)
# the sustained rate of the forward's product instruction alone: every
# warp issues ILP independent mma.sync m16n8k8 tf32 products per step
MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int ILP = 8;
__global__ void mma_tf32_loop(float* out, int steps) {
  float c[ILP][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x - i);
  for (int s = 0; s < steps; ++s)
#pragma unroll
    for (int j = 0; j < ILP; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  float sum = 0.f;
  for (int j = 0; j < ILP; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int mma_tf32_peak(void* out, int blocks, int threads, int steps,
                             void* stream) {
  mma_tf32_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
"""


def variants(src: str) -> dict:
    def sub(text, name, value):
        old = f"constexpr int {name} = "
        start = text.index(old) + len(old)   # raises if the anchor is gone
        end = text.index(";", start)
        return text[:start] + str(value) + text[end:]
    body = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
    cvt = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : '
           '"f"(x));\n  return r;\n')
    cross = "  mma_tf32(c, a_small, b_big[0], b_big[1]);\n"
    if body not in src or cross not in src:
        raise ValueError("the split's anchors are gone")
    return {"base": src,
            "b3": sub(src, "F32_MIN_BLOCKS_64", 3),
            "k64_b2": sub(sub(src, "F32_BK", 64), "F32_MIN_BLOCKS_64", 2),
            "cvt": src.replace(body, cvt),
            "two_mma": src.replace(cross, "")}


def build(sources: dict) -> dict:
    """``{name: source}`` -> ``{name: (fwd entry, bias fwd entry)}``."""
    from paddle_tpu_torch.ops import kernels
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"flash_fwd_{name}.cu")
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
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                f32 = ("flash_fwd_f32_kernelILi64" in fn
                       or "flash_fwd_kernelIfLi64" in fn)
                entry = fn[fn.index("flash_fwd"):] if f32 else None
            elif entry and ("registers" in line or "spill" in line):
                print(f"{name} ptxas {entry}: "
                      f"{line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"flash_fwd_{name}.so"))
        fwd, bias_fwd = lib.flash_attention_fwd, lib.flash_attention_bias_fwd
        fwd.argtypes = kernels.FLASH_ATTENTION_FWD.argtypes
        bias_fwd.argtypes = kernels.FLASH_ATTENTION_BIAS_FWD.argtypes
        fwd.restype = bias_fwd.restype = ctypes.c_int
        fns[name] = (fwd, bias_fwd)
    return fns


def mma_peak(smoke) -> None:
    """Print the TFLOP/s that mma.sync m16n8k8 tf32 sustains on the card,
    at 4 and 16 warps an SM."""
    import torch
    from paddle_tpu_torch.ops import kernels
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "mma_tf32_peak.cu")
    with open(cu, "w") as f:
        f.write(MMA_PEAK_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                    cu[:-3] + ".so", cu], check=True, capture_output=True)
    fn = ctypes.CDLL(cu[:-3] + ".so").mma_tf32_peak
    fn.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    steps, stream = 4096, torch.cuda.current_stream().cuda_stream
    for warps in (4, 16):
        blocks, threads = sms * warps // 4, 128
        out = torch.empty(blocks * threads, device="cuda")
        ms = smoke._median_ms(lambda: fn(out.data_ptr(), blocks, threads,
                                         steps, stream), iters=10)
        flops = blocks * threads // 32 * steps * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 tf32 alone, {warps} warps an SM: "
              f"{flops / ms / 1e9:.1f} TFLOP/s ({ms:.4f} ms)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--also", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another flash_attention_fwd.cu, timed too")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("time_torch_flash_f32.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        _dropout_args, flash_attention_plain)
    sources = variants((kernels.CSRC_DIR / "flash_attention_fwd.cu")
                       .read_text())
    for name, path in (a.split("=", 1) for a in args.also):
        with open(path) as f:
            sources[name] = f.read()
    fns = build(sources)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card: {torch.cuda.get_device_name(0)}")
    mma_peak(smoke)

    # (name, B, S, H, D, causal, bias or None, rate)
    mask = smoke.pretraining_batch(smoke.BERT_B, smoke.BERT_S, smoke.BERT_M,
                                   30528)[0][2]
    bias = smoke._key_bias(mask, torch.float32)
    shapes = (("serve", 4, 256, 16, 64, True, None, 0.0),
              ("bert", 48, 512, 12, 64, False, bias, 0.0),
              ("bert dropout 0.1", 48, 512, 12, 64, False, bias, 0.1))
    cases = []
    for name, B, S, H, D, causal, bi, rate in shapes:
        g = torch.Generator(device="cuda").manual_seed(S + H)
        q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty(B, H, S, device="cuda")
        o_ref, lse_ref = flash_attention_plain(
            q, k, v, causal, None, True, rate, WORDS, bi)
        pairs = (B * H * S * (S + 1) // 2 if bi is None
                 else H * S * int(mask.sum()))
        nbytes = 4 * B * S * H * D * 4 + B * H * S * 4 + (
            0 if bi is None else B * S * 4)
        bound = smoke._bound_ms(nbytes, 4 * D * pairs, "float32_3xtf32")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mk = None if bi is None else bi[:, None, None, :]

        def sdpa(qt=qt, kt=kt, vt=vt, mk=mk, causal=causal, rate=rate):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mk, dropout_p=rate, is_causal=causal)
        cases.append((name, (q, k, v, o, lse, B, S, H, D, causal, bi, rate),
                      o_ref, lse_ref, bound, sdpa))
        print(f"{name}: B={B} S={S} H={H} D={D} causal={causal} "
              f"bias={bi is not None} rate={rate}: bound {bound[0]:.4f} ms "
              f"({bound[1]})")

    def call(fns_, t):
        q, k, v, o, lse, B, S, H, D, causal, bi, rate = t
        tail = (B, S, S, H, D, int(causal), D ** -0.5,
                *_dropout_args(rate, WORDS), 0, stream)
        if bi is None:
            return fns_[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), *tail)
        return fns_[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bi.data_ptr(), o.data_ptr(), lse.data_ptr(), *tail)

    for name in list(fns):
        notes = []
        for cname, t, o_ref, lse_ref, _, _ in cases:
            o, lse = t[3], t[4]
            o.fill_(float("nan"))
            err = call(fns[name], t)
            first = o.clone()
            err = err or call(fns[name], t)
            torch.cuda.synchronize()
            o_err = float("inf") if err else (o - o_ref).abs().max().item()
            l_err = float("inf") if err else (lse - lse_ref).abs().max().item()
            ok = (o_err <= smoke.TOL["float32"] and l_err <= 1e-5
                  and torch.equal(first, o))
            notes.append(f"{cname} o {o_err:.3e} lse {l_err:.3e}"
                         + ("" if ok else " FAIL"))
        print(f"{name:5s} " + ", ".join(notes))

    from torch.profiler import ProfilerActivity, profile
    for cname, _, _, _, _, sdpa in cases:
        sdpa()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sdpa()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type.name == "CUDA"})
        print(f"SDPA f32 {cname} runs: {names}")
    for rnd in range(2):
        for name, f in fns.items():
            print(f"round {rnd} {name:5s} " + ", ".join(
                f"{c[0]} {smoke._median_ms(lambda: call(f, c[1])):.4f} ms"
                for c in cases))
        print(f"round {rnd} SDPA  " + ", ".join(
            f"{c[0]} {smoke._median_ms(c[5]):.4f} ms" for c in cases))
    return 0


if __name__ == "__main__":
    sys.exit(main())
