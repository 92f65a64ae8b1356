"""Device time of the port's flash backward, the entries of
``paddle_tpu_torch/csrc/flash_attention_bwd.cu``, at the shapes of the
paths that launch them.

``--shape``, one or more by commas (all D = 64, dropout 0.1):

- ``gpt``: GPT-2 345M's training shape (B=8, S=1024, H=16, causal), the
  no-bias ``flash_attention_bwd`` (row 3 of ``PERF.md``);
- ``rank``: a dp = 2 x mp = 2 rank's share of it (B=2, H=8), the f32
  parity runs' shape (row 3 (f32));
- ``bert``: BERT-base's padded batch (B=48, S=512, H=12, the key bias of
  ``chip_smoke.py``'s ``pretraining_batch`` mask), the biased entries
  ``flash_attention_bias_bwd_dq`` and ``_dkv`` (rows 4 and 5), each
  timed.

``--dtype`` is ``bfloat16`` (the default) or ``float32``. ``--variant
NAME:CONST=VALUE[,CONST=VALUE...]`` (repeatable) also times the
checkout's source with those ``constexpr int`` constants set to the
values, built with the repository's ``nvcc`` flags into
``paddle_tpu_torch/_build/variants/`` (its ptxas register and spill lines
printed) and held bit for bit to the checkout's own build.
``--profile`` adds, for each entry and variant, the device time a call
of each kernel it launches takes, from ``torch.profiler``.

Run it from the root of the checkout whose kernels it should time (it
imports ``paddle_tpu_torch`` from the working directory). Prints one JSON
line per entry and variant: the card's name and power limit as
``nvidia-smi`` reports them, the median of ``--reps`` launches each
timed by its own pair of CUDA events, checksums of the gradients and of
the forward's o (so two checkouts' bits can be compared), and the
checkout's directory name. To compare two versions of the source, run it
from both checkouts on the same card, one after the other, in the order
A, B, B, A::

    python3 tools/time_flash_bwd.py --dtype float32 --shape rank
    (cd ../other_checkout && python3 ../repo/tools/time_flash_bwd.py \\
        --dtype float32 --shape rank)
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"gpt": (8, 1024, 16, True), "rank": (2, 1024, 8, True),
          "bert": (48, 512, 12, False)}
WORDS = (0x2468ACE0, 0x13579BDF)
ENTRIES = ("flash_attention_bwd", "flash_attention_bias_bwd_dq",
           "flash_attention_bias_bwd_dkv")


def _median_ms(torch, fn, reps: int):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        # the card spins first, so the launch is queued before the start
        torch.cuda._sleep(200_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2], times[0]


def _kernel_us(torch, fn, calls: int = 10) -> dict:
    """Device microseconds a call of each kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            m = re.search(r"(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + us / calls
    return out


def _bert_bias(torch, B, S):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mask = smoke.pretraining_batch(B, S, smoke.BERT_M, 30528)[0][2]
    return ((1.0 - torch.from_numpy(mask).float()) * -1e30).cuda()


def build_variants(specs: dict) -> dict:
    """``{name: {CONST: value}}`` -> ``{name: {entry: C function}}``: the
    checkout's backward source with those constants replaced, one nvcc
    process a variant, all started together."""
    from paddle_tpu_torch.ops import kernels
    with open(os.path.join(kernels.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        base = f.read()
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, consts in specs.items():
        text = base
        for const, value in consts.items():
            text, n = re.subn(rf"(constexpr int {const} = )[^;]*;",
                              rf"\g<1>{value};", text)
            if n != 1:
                raise ValueError(f"constexpr int {const} not found once")
        cu = os.path.join(out_dir, f"flash_bwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (cu, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC_DIR), "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (cu, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                entry = fn if "f32_kernel" in fn else None
            elif entry and ("registers" in line or "spill" in line):
                print(f"{name} ptxas {entry}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(cu[:-3] + ".so")
        out[name] = {}
        for e in ENTRIES:
            fn = getattr(lib, e)
            fn.argtypes = kernels.KERNELS[e].argtypes
            fn.restype = ctypes.c_int
            out[name][e] = fn
    return out


def _time_shape(torch, fa, kernels, shape_name, dtype, variants, args,
                card) -> None:
    B, S, H, causal = SHAPES[shape_name]
    D, rate = 64, 0.1
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    if shape_name == "bert":
        bias = _bert_bias(torch, B, S)
        o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, False, None,
                                             True, rate, WORDS)
        bwd = (fa.flash_attention_bias_bwd_dq, fa.flash_attention_bias_bwd_dkv)
        runs = {e.__name__: (lambda e=e: e(q, k, v, bias, o, lse, do, False,
                                           None, rate, WORDS)) for e in bwd}
    else:
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, True, rate,
                                        WORDS)
        runs = {"flash_attention_bwd": lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal, None, rate, WORDS)}
    shape = (f"B={B} S={S} H={H} D={D} {str(dtype)[6:]} "
             f"{'causal' if causal else 'key bias'} dropout {rate}")
    own = {}
    for vname, fns in variants.items():
        saved = {e: kernels.function(e) for e in ENTRIES}
        if fns is not None:
            kernels._FUNCS.update(fns)
        try:
            for entry, run in runs.items():
                med, low = _median_ms(torch, run, args.reps)
                out = run()
                outs = out if isinstance(out, tuple) else (out,)
                if fns is None:
                    own[entry] = outs
                same = all(torch.equal(a, b)
                           for a, b in zip(outs, own[entry]))
                kern = _kernel_us(torch, run) if args.profile else None
                print(json.dumps({
                    "card": card, "shape": shape, "entry": entry,
                    "variant": vname, "median_ms": med, "min_ms": low,
                    "reps": args.reps, "bit_equal_to_checkout": same,
                    "kernel_us": kern,
                    "checksum": [float(t.float().abs().sum()) for t in outs],
                    "fwd_checksum": float(o.float().abs().sum()),
                    "checkout": os.path.basename(os.getcwd())}), flush=True)
        finally:
            kernels._FUNCS.update(saved)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--shape", default="gpt",
                    help="one or more of " + ", ".join(SHAPES) + ", by commas")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME:CONST=VALUE[,CONST=VALUE]")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    specs = {}
    for spec in args.variant:
        name, _, assigns = spec.partition(":")
        specs[name] = dict(a.split("=") for a in assigns.split(","))
    variants = {"checkout": None, **build_variants(specs)}
    for shape_name in args.shape.split(","):
        _time_shape(torch, fa, kernels, shape_name, getattr(torch, args.dtype),
                    variants, args, smi.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
