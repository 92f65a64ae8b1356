#!/usr/bin/env python3
"""What bounds the int8 matmul kernel on the card: time variants of
``paddle_tpu_torch/csrc/quant_matmul.cu``.

Each variant is the checkout's source with one change made by text
substitution: the ring of shared-memory stages (``STAGES``, variant
``sN``), or no epilogue stores (``nostore``: the output tile's TMA
stores sit behind a condition that is false at run time, so the
products are still computed and staged; its output is not checked).
Every variant is built with the repository's ``nvcc`` flags into
``paddle_tpu_torch/_build/int8_variants/``
(one process each, all at once), checked bit-equal to the plain version
and timed, the weight K-major, at ``chip_smoke.py``'s ``INT8_SHAPES``
(the int8 BERT-base predictor's (M, K, N)) with float32 and bfloat16
output. Two rounds, so the spread shows. Run from the root of a
checkout::

    python3 tools/time_torch_int8_variants.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGES = (3, 4)


def variants(src: str) -> dict:
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"variant anchor not in the source: {old!r}")
        return text.replace(old, new)
    out = {"base": src}
    for n in STAGES:
        out[f"s{n}"] = sub(src, "constexpr int STAGES = 5;",
                           f"constexpr int STAGES = {n};")
    out["nostore"] = sub(src, "tma_store(&tm_out,",
                         "if (K < 0) tma_store(&tm_out,")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_torch_int8_variants.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    out_dir = os.path.join(kernels.BUILD_DIR, "int8_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = (kernels.CSRC_DIR / "quant_matmul.cu").read_text()
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
        fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")).int8_matmul
        fn.argtypes = kernels.INT8_MATMUL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name:9s} ptxas: {'; '.join(regs)}")

    print(f"card: {torch.cuda.get_device_name(0)}")
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for M, K, N in smoke.INT8_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(M + K + N)
        x_q, a_s = qm.quantize_per_tensor(
            torch.randn(M, K, device="cuda", generator=g))
        w_q, w_s = qm.quantize_per_channel(
            torch.randn(K, N, device="cuda", generator=g) * 0.02)
        w_t = w_q.t().contiguous()
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            out = torch.empty(M, N, dtype=dtype, device="cuda")
            ref = qm.int8_matmul_plain(x_q, w_q, w_s, a_s, dtype)
            cases.append((f"M={M} K={K} N={N} {smoke._name(dtype)}",
                          (x_q, w_t, w_s, a_s, out, M, K, N, code), ref))
    for rnd in range(2):
        for label, (x_q, w_t, w_s, a_s, out, M, K, N, code), ref in cases:
            times = []
            for name, fn in fns.items():
                def call():
                    return fn(x_q.data_ptr(), w_t.data_ptr(), w_s.data_ptr(),
                              a_s.data_ptr(), out.data_ptr(), M, K, N, code,
                              stream)
                if rnd == 0 and name != "nostore":
                    out.zero_()
                    err = call()
                    torch.cuda.synchronize()
                    if err or not torch.equal(out, ref):
                        raise RuntimeError(f"variant {name} at {label}: "
                                           f"error {err} or not bit-equal")
                times.append(f"{name} {smoke._median_ms(call):.4f}")
            print(f"round {rnd} {label}: " + ", ".join(times) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
