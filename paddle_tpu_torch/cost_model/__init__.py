"""Cost model (reference: python/paddle/cost_model/cost_model.py —
profile_measure running a program under the profiler to collect op
costs).

Port of ``paddle_tpu/cost_model/__init__.py``. The JAX module reads
XLA's static cost analysis of a lowered program; the port has no
program, so :meth:`CostModel.attribute` runs the callable once and
counts it two ways at once:

- ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
  PyTorch operators (matmuls, convolutions, SDPA), and a dispatch mode
  of this module counts their bytes (every tensor argument read once,
  every output written once);
- the hand-written kernels are ``ctypes`` calls, which neither mode
  sees: each kernel wrapper reports its own FLOPs and bytes
  (``ops.kernels.note_cost``, the formulas of ``chip_smoke.py``'s
  bounds) and runs its plain version, where it runs one, out of the
  modes' sight (``ops.kernels.uncounted``), so nothing counts twice.

:meth:`CostModel.profile_measure` adds the callable's time on the card,
from CUDA events. :data:`PEAK_FLOPS` holds the H100's dense bf16 peaks,
matched as prefixes of ``torch.cuda.get_device_name()``; the MFU math of
``TrainStep`` divides by it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CostModel", "device_peak_flops", "summarize", "PEAK_FLOPS"]

# Peak dense bf16 tensor-core FLOP/s a card (NVIDIA data sheets, at the
# card's maximum power limit), keyed by a prefix of the device name.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,     # SXM
    "NVIDIA H100 PCIe": 756e12,
}


def device_peak_flops(device=None, default: Optional[float] = None) \
        -> Optional[float]:
    """Peak dense FLOP/s of ``device`` (default: the current card) from
    :data:`PEAK_FLOPS`; ``default`` (None) without a card or for an
    unknown one, where an MFU number would be fiction."""
    try:
        if not torch.cuda.is_available():
            return default
        name = torch.cuda.get_device_name(device)
    except Exception:
        return default
    for prefix, peak in PEAK_FLOPS.items():
        if name.startswith(prefix):
            return peak
    return default


class _BytesMode(TorchDispatchMode):
    """Counts the bytes of every operator: each tensor argument read
    once, each tensor output written once (views move nothing)."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            ts = [*pytree.tree_leaves((args, kwargs)),
                  *pytree.tree_leaves(out)]
            self.nbytes += sum(t.numel() * t.element_size() for t in ts
                               if isinstance(t, torch.Tensor))
        return out


def summarize(flop_counter, bytes_mode, sink) -> Dict[str, object]:
    """The counts of one counted run: a ``FlopCounterMode``, a
    :class:`_BytesMode` and an ``ops.kernels.cost_sink`` dict, as
    ``{'flops', 'bytes_accessed', 'arithmetic_intensity',
    'torch_flops', 'torch_bytes', 'kernel_flops', 'kernel_bytes',
    'kernels'}`` (``kernels``: each hand-written kernel's ``{'calls',
    'flops', 'bytes'}``; the totals add the two routes)."""
    tflops = float(flop_counter.get_total_flops())
    tbytes = float(bytes_mode.nbytes)
    kflops = sum(e[1] for e in sink.values())
    kbytes = sum(e[2] for e in sink.values())
    flops, nbytes = tflops + kflops, tbytes + kbytes
    return {"flops": flops, "bytes_accessed": nbytes,
            "arithmetic_intensity": flops / nbytes if nbytes else 0.0,
            "torch_flops": tflops, "torch_bytes": tbytes,
            "kernel_flops": kflops, "kernel_bytes": kbytes,
            "kernels": {k: {"calls": int(e[0]), "flops": e[1],
                            "bytes": e[2]}
                        for k, e in sorted(sink.items())}}


class CostModel:
    def attribute(self, fn, args: Sequence = ()) -> Dict[str, object]:
        """Run ``fn(*args)`` once and count its work (:func:`summarize`).
        ``TrainStep`` counts its first step under ``FLAGS_monitor`` the
        same way."""
        from torch.utils.flop_counter import FlopCounterMode

        from ..ops import kernels as K
        with K.cost_sink() as sink, \
                FlopCounterMode(display=False) as fc, _BytesMode() as bm:
            fn(*args)
        return summarize(fc, bm, sink)

    def mfu(self, flops_per_step: float, step_seconds: float,
            device=None, peak_flops: Optional[float] = None) \
            -> Optional[float]:
        """Model-FLOPs utilization from an attributed FLOP count and a
        measured step time; None when the card's peak is unknown."""
        peak = peak_flops if peak_flops is not None \
            else device_peak_flops(device)
        if not peak or step_seconds <= 0:
            return None
        return flops_per_step / step_seconds / peak

    def profile_measure(self, fn, args: Sequence = (), iters: int = 10,
                        warmup: int = 2) -> Dict[str, float]:
        """Count ``fn(*args)`` (:meth:`attribute`, one extra call) and
        time it: ``{'flops', 'bytes_accessed', 'wall_ms',
        'achieved_tflops'}``. With a card the time comes from CUDA
        events around ``iters`` calls; without one from the host
        clock."""
        cost = self.attribute(fn, args)
        cuda = torch.cuda.is_available()
        for _ in range(max(1, warmup)):
            fn(*args)
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            wall = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            wall = (time.perf_counter() - t0) / iters
        flops = float(cost["flops"])
        return {
            "flops": flops,
            "bytes_accessed": float(cost["bytes_accessed"]),
            "wall_ms": wall * 1e3,
            "achieved_tflops": flops / wall / 1e12 if wall > 0 else 0.0,
        }
