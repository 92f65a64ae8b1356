"""Kernel registry and build helper for the hand-written Hopper kernels.

Counterpart of the ``paddle_tpu/ops/pallas/__init__.py`` registry. Each
entry names a CUDA C++ source under ``paddle_tpu_torch/csrc/``, the TPU
kernel it replaces and a plain launch counter that its wrapper bumps
once per launch (and nowhere else), so a run can show that its main
path really went through the kernel.

There are no kill switches and no fallbacks: a wrapper given CPU tensors
computes its plain PyTorch version; given CUDA tensors it launches the
kernel or raises.

Build: each source compiles on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``paddle_tpu_torch/_build/<stem>-<hash>.so`` (the hash
covers the source and the ``csrc/*.cuh`` headers it may include, so an
edited source or header rebuilds) and loads through ``ctypes``. Sources
share no header with PyTorch, which keeps a build at seconds, not
minutes. :func:`build` compiles every missing library at once, one
``nvcc`` process per source, all started together; kernels that share a
source (the two chunked-CE entries, the flash forward with and without
a key bias, the three flash backward entries, paged decode over full
or int8 pools) share its library.

The registry also counts the calls that the JAX package's routing sends
to a plain composition by shape (:func:`note_fallback`): a run can show
that none of its calls took that route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Kernel", "KERNELS", "FALLBACKS", "kernels", "reset_launch_counts",
           "note_fallback", "build", "build_log", "function", "check",
           "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = Path(__file__).resolve().parents[2]          # paddle_tpu_torch/
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Kernel:
    """One hand-written kernel: its C entry point, its source, the TPU
    kernel it replaces and the count of its launches."""

    name: str
    source: str          # repo-relative path of the .cu file
    replaces: str        # file:line of the pallas_call it ports
    argtypes: tuple      # ctypes signature of the C entry point
    launches: int = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L = ctypes.c_uint, ctypes.c_longlong

FLASH_ATTENTION_FWD = Kernel(
    "flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
    "paddle_tpu/ops/pallas/flash_attention.py:399",
    # q, k, v, o, lse, B, Sq, Sk, H, D, causal, scale, dropout, thr,
    # seed, keep_scale, dtype, stream
    (_P,) * 5 + (_I,) * 6 + (_F, _I, _U, _U, _F, _I, _P))
FLASH_ATTENTION_BWD = Kernel(
    "flash_attention_bwd", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "paddle_tpu/ops/pallas/flash_attention.py:532",
    # q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, D, causal,
    # scale, dropout, thr, seed, keep_scale, dtype, stream
    (_P,) * 10 + (_I,) * 6 + (_F, _I, _U, _U, _F, _I, _P))
CHUNKED_CE_LSE = Kernel(
    "chunked_ce_lse", "paddle_tpu_torch/csrc/chunked_ce.cu",
    "paddle_tpu/ops/pallas/chunked_ce.py:128",
    # logits, lse, N, V, dtype, stream
    (_P, _P, _I, _I, _I, _P))
CHUNKED_CE_DLOGITS = Kernel(
    "chunked_ce_dlogits", "paddle_tpu_torch/csrc/chunked_ce.cu",
    "paddle_tpu/ops/pallas/chunked_ce.py:168",
    # logits, labels, lse, g, out, N, V, dtype, stream
    (_P,) * 5 + (_I, _I, _I, _P))
FUSED_DROPOUT = Kernel(
    "fused_dropout", "paddle_tpu_torch/csrc/dropout.cu",
    "paddle_tpu/ops/pallas/dropout.py:69",
    # x, y, n, seed, thr, inv, dtype, stream
    (_P, _P, _L, _U, _U, _F, _I, _P))
FLASH_ATTENTION_BIAS_FWD = Kernel(
    "flash_attention_bias_fwd", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
    "paddle_tpu/ops/pallas/flash_attention.py:239",
    # q, k, v, bias, o, lse, B, Sq, Sk, H, D, causal, scale, dropout, thr,
    # seed, keep_scale, dtype, stream
    (_P,) * 6 + (_I,) * 6 + (_F, _I, _U, _U, _F, _I, _P))
FLASH_ATTENTION_BIAS_BWD_DQ = Kernel(
    "flash_attention_bias_bwd_dq",
    "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "paddle_tpu/ops/pallas/flash_attention.py:702",
    # q, k, v, bias, o, lse, dout, dq, B, Sq, Sk, H, D, causal, scale,
    # dropout, thr, seed, keep_scale, dtype, stream
    (_P,) * 8 + (_I,) * 6 + (_F, _I, _U, _U, _F, _I, _P))
FLASH_ATTENTION_BIAS_BWD_DKV = Kernel(
    "flash_attention_bias_bwd_dkv",
    "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "paddle_tpu/ops/pallas/flash_attention.py:753",
    # q, k, v, bias, o, lse, dout, dk, dv, db_h, db, B, Sq, Sk, H, D,
    # causal, scale, dropout, thr, seed, keep_scale, dtype, stream
    (_P,) * 11 + (_I,) * 6 + (_F, _I, _U, _U, _F, _I, _P))
PAGED_DECODE = Kernel(
    "paged_decode_attention", "paddle_tpu_torch/csrc/paged_decode.cu",
    "paddle_tpu/ops/pallas/paged_decode.py:149",
    # q, k_pages, v_pages, table, pos, out, B, H, D, bs, MB, scale,
    # dtype, stream
    (_P,) * 6 + (_I,) * 5 + (_F, _I, _P))

PAGED_DECODE_QUANT = Kernel(
    "paged_decode_attention_quant", "paddle_tpu_torch/csrc/paged_decode.cu",
    "paddle_tpu/ops/pallas/paged_decode.py:199",
    # q, k_pages, k_scales, v_pages, v_scales, table, pos, out, B, H, D,
    # bs, MB, scale, stream
    (_P,) * 8 + (_I,) * 5 + (_F, _P))
BGMV = Kernel(
    "bgmv", "paddle_tpu_torch/csrc/bgmv.cu",
    "paddle_tpu/ops/pallas/bgmv.py:103",
    # x, a, b, ids, out, B, S, E, r, O, dtype, stream
    (_P,) * 5 + (_I,) * 6 + (_P,))

INT8_MATMUL = Kernel(
    "int8_matmul", "paddle_tpu_torch/csrc/quant_matmul.cu",
    "paddle_tpu/ops/pallas/quant_matmul.py:168",
    # x_q, w_t (the weight K-major, [N, K]), w_scale, act_scale (a device
    # pointer to one f32), out, M, K, N, dtype, stream
    (_P,) * 5 + (_I,) * 4 + (_P,))

KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    FLASH_ATTENTION_FWD, FLASH_ATTENTION_BWD, CHUNKED_CE_LSE,
    CHUNKED_CE_DLOGITS, FUSED_DROPOUT, PAGED_DECODE,
    FLASH_ATTENTION_BIAS_FWD, FLASH_ATTENTION_BIAS_BWD_DQ,
    FLASH_ATTENTION_BIAS_BWD_DKV, PAGED_DECODE_QUANT, BGMV, INT8_MATMUL)}

#: calls that the JAX package's own routing sends past a kernel (today
#: only ``("int8_matmul", "shape")``: a ``slim.QuantizedLinear`` or AMP
#: int8 linear whose K or N does not tile), by (kernel, reason)
FALLBACKS: Dict[tuple, int] = {}


def kernels() -> List[dict]:
    """Every kernel with its TPU counterpart, source and launch count."""
    return [{"name": k.name, "source": k.source, "replaces": k.replaces,
             "launches": k.launches} for k in KERNELS.values()]


def reset_launch_counts() -> None:
    """Set every launch count and every :data:`FALLBACKS` count to 0."""
    for k in KERNELS.values():
        k.launches = 0
    FALLBACKS.clear()


def note_fallback(kernel: str, reason: str) -> None:
    """Count a call that the reference's routing sends past ``kernel``
    for ``reason`` (``paddle_tpu/ops/pallas/__init__.py::note_fallback``).
    It counts a choice by shape, never a failure: on the card a wrapper
    launches its kernel or raises."""
    FALLBACKS[(kernel, reason)] = FALLBACKS.get((kernel, reason), 0) + 1


_LOCK = threading.Lock()
_FUNCS: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def _lib_path(kernel: Kernel) -> Path:
    src = _PKG_DIR.parent / kernel.source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Sequence[str]] = None) -> float:
    """Compile every missing kernel library (all of them, or ``names``)
    in parallel and load them. Returns the seconds spent."""
    t0 = time.perf_counter()
    todo = [KERNELS[n] for n in (names or KERNELS)]
    with _LOCK:
        # one nvcc per library, however many entries it holds
        missing = {_lib_path(k): k for k in todo
                   if k.name not in _FUNCS and not _lib_path(k).exists()}
        if missing:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for out, k in missing.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                with open(out.with_suffix(".log"), "w") as log:
                    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                           str(tmp), str(_PKG_DIR.parent / k.source)]
                    procs.append((k, out, tmp, subprocess.Popen(
                        cmd, stdout=log, stderr=subprocess.STDOUT)))
            failed = []
            for k, out, tmp, p in procs:
                if p.wait() != 0:
                    failed.append(f"{k.source}: nvcc exit {p.returncode}\n"
                                  + out.with_suffix(".log").read_text())
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("kernel build failed:\n"
                                   + "\n".join(failed))
        for k in todo:
            if k.name not in _FUNCS:
                _FUNCS[k.name] = _load(k)
    return time.perf_counter() - t0


def _load(kernel: Kernel) -> Callable[..., int]:
    fn = getattr(ctypes.CDLL(str(_lib_path(kernel))), kernel.name)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    return fn


def build_log(name: str) -> str:
    """What nvcc printed for the kernel's last build (register and
    shared-memory use per instantiation, from ``-Xptxas -v``)."""
    p = _lib_path(KERNELS[name]).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def function(name: str) -> Callable[..., int]:
    """The C entry point of kernel ``name``, built at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        build([name])
        fn = _FUNCS[name]
    return fn


def check(name: str, err: int) -> None:
    """Raise when a C entry returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
