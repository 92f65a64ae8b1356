#!/usr/bin/env python3
"""Choose the bgmv kernel's schedule on the card: time variants of
``paddle_tpu_torch/csrc/bgmv.cu``.

Each variant is the checkout's source with its schedule constants
changed by text substitution: the blocks of a cluster (``DECODE_CLUSTER``
at S = 1, ``PREFILL_CLUSTER`` above) and the tokens a cluster takes
(``ST``); variant ``cCtT`` sets both cluster sizes to C and ST to T,
``base`` is the source as it is; ``noop`` is it with the kernel
returning at once (wrong, timed only: the cost of the cluster launch
alone). ``--also NAME=PATH`` adds the bgmv source at PATH (an older
tree's, with the same C entry) as variant NAME, so an earlier design is
timed in the same call. Every variant is built with
the repository's ``nvcc`` flags into ``paddle_tpu_torch/_build/
variants/`` (one process each, all at once), checked against the plain
version at ``chip_smoke.py``'s two dispatch shapes (within BGMV_TOL, the
zero-adapter rows exactly +0.0, two launches bit-equal) and timed there
with the L2 cache flushed before every launch, in float32, by writing a
128 MB buffer (chip_smoke.py's flush, which leaves dirty lines for the
timed launch to write back) and by reading it (clean lines): the decode
dispatch (B=8, S=1) and the prefill one (B=4, S=256), E=1024, r=8,
O=3072. Two rounds, so the spread shows. Run from the root of a
checkout::

    python3 tools/time_torch_bgmv_variants.py [--also first=OLD/bgmv.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (CLUSTER, ST) of each variant
SCHEDULES = tuple((c, t) for c in (2, 4, 8, 16) for t in (4, 8, 16))
# chip_smoke.py's bgmv dispatch shapes: (B, S, ids)
SHAPES = ((8, 1, [0, 1, 2, 3, 0, 5, 8, 8]), (4, 256, [3, 0, 7, 3]))


def variants(src: str) -> dict:
    def sub(text, name, value):
        old = f"constexpr int {name} = "
        start = text.index(old) + len(old)   # raises if the anchor is gone
        end = text.index(";", start)
        return text[:start] + str(value) + text[end:]
    body = "  extern __shared__ float4 smem4[];\n  float* Bs"
    if body not in src:
        raise ValueError("the kernel body's anchor is gone")
    out = {"base": src, "noop": src.replace(body, "  return;\n" + body)}
    for c, t in SCHEDULES:
        out[f"c{c}t{t}"] = sub(sub(sub(src, "DECODE_CLUSTER", c),
                                   "PREFILL_CLUSTER", c), "ST", t)
    return out


def build(sources: dict) -> dict:
    """``{name: source text}`` -> ``{name: the library's bgmv entry}``."""
    from paddle_tpu_torch.ops import kernels
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"bgmv_{name}.cu")
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
        fn = ctypes.CDLL(os.path.join(out_dir, f"bgmv_{name}.so")).bgmv
        fn.argtypes = kernels.BGMV.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--also", action="append", default=[],
                    metavar="NAME=PATH", help="another bgmv.cu, timed too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_torch_bgmv_variants.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.bgmv import bgmv_plain
    sources = variants((kernels.CSRC_DIR / "bgmv.cu").read_text())
    for name, path in (a.split("=", 1) for a in args.also):
        with open(path) as f:
            sources[name] = f.read()
    fns = build(sources)

    E, r, O, A = 1024, 8, 3072, 9
    cases = []
    for B, S, ids in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(31 + S)
        x = torch.randn(B, S, E, device="cuda", generator=g)
        a = torch.randn(A, r, E, device="cuda", generator=g)
        b = torch.randn(A, r, O, device="cuda", generator=g)
        a[0] = 0.0
        b[0] = 0.0
        ids_t = torch.tensor(ids, dtype=torch.int32, device="cuda")
        out = torch.empty(B, S, O, device="cuda")
        nbytes = (x.numel() * 4 + out.numel() * 4
                  + len(set(ids)) * r * (E + O) * 4 + 4 * B)
        bound, by = smoke._bound_ms(nbytes, 2 * B * S * r * (E + O),
                                    "float32")
        cases.append((f"B={B} S={S}", (x, a, b, ids_t, out), ids,
                      bgmv_plain(x, a, b, ids_t), bound, by))
    stream = torch.cuda.current_stream().cuda_stream
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    print(f"card: {torch.cuda.get_device_name(0)}")
    for shape, _, _, _, bound, by in cases:
        print(f"{shape}: bound {bound:.4f} ms ({by})")

    def call(fn, t):
        x, a, b, ids_t, out = t
        B, S, _ = x.shape
        return fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), ids_t.data_ptr(),
                  out.data_ptr(), B, S, E, r, O, 0, stream)

    for name in list(fns):
        notes = []
        for shape, t, ids, ref, _, _ in cases:
            out = t[-1]
            out.fill_(float("nan"))
            err = call(fns[name], t)
            first = out.clone()
            err = err or call(fns[name], t)
            torch.cuda.synchronize()
            rel = float("inf") if err else (
                (out - ref).abs().max() / ref.abs().max()).item()
            zero = [i for i, k in enumerate(ids) if k == 0]
            ok = (rel <= smoke.BGMV_TOL["float32"]
                  and torch.equal(first, out)
                  and bool((out[zero] == 0).all())
                  and not bool(out[zero].signbit().any()))
            notes.append(f"{shape} rel {rel:.3e}{'' if ok else ' FAIL'}")
            if not ok and name != "noop":
                del fns[name]
                break
        print(f"{name:6s} " + ", ".join(notes))
    # the flush chip_smoke.py uses writes the scrub buffer, which leaves L2
    # full of dirty lines that the timed launch writes back; reading it
    # leaves clean ones
    flushes = (("dirty", scrub.zero_), ("clean", lambda: scrub.max()))
    for rnd in range(2):
        for name, fn in fns.items():
            print(f"round {rnd} {name:6s} " + ", ".join(
                f"{c[0]} {fl} {smoke._median_ms(lambda: call(fn, c[1]), flush=f):.4f} ms"
                for fl, f in flushes for c in cases))
    return 0


if __name__ == "__main__":
    sys.exit(main())
