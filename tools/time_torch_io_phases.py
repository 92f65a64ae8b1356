"""Run chip_smoke's bf16-pools phase (16) and the DataLoader-fed part of
its io phase (17) alone on the card, with the io run's consumer wait
split into its parts.

Run it from the root of a checkout (it imports that checkout's
``chip_smoke`` and ``paddle_tpu_torch``)::

    python3 tools/time_torch_io_phases.py

It builds the kernels (chip_smoke phase 1, which prints the card's name
and power limit), runs phase 16 with every check of chip_smoke (its
phase-14 comparison line reads n/a: phase 14 does not run here), then
the DataLoader-fed, saved and resumed BERT-base run of phase 17 with
each of the loader's queue reads (``inner_next``), pinned copies
(``launch``) and consumer waits (``wait``) timed on the host clock, and
every collection of the garbage collector's oldest generation that took
over 10 ms.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    import chip_smoke as cs
    from paddle_tpu_torch.io import dataloader as dl
    cs.phase_card()
    na = {"kv_bytes_per_token": 0, "tokens_per_sec": 0.0,
          "ttft_p50_s": None, "ttft_p99_s": None,
          "decode_step_p50_s": None, "decode_step_p99_s": None,
          "mean_decode_occupancy": 0.0}
    cs.phase_bf16_pools({"summary": na, "peak": (0.0, 0.0)})

    events = []

    def timed(name, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                events.append((name, time.perf_counter() - t))
        return wrapper

    gc_start = []

    def on_gc(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            gc_start.append(time.perf_counter())
        elif gc_start:
            took = time.perf_counter() - gc_start.pop()
            if took > 0.01:
                events.append(("gc gen 2", took))

    dl._MultiprocessIter.__next__ = timed("inner_next",
                                          dl._MultiprocessIter.__next__)
    dl._DevicePrefetcher._launch = timed("launch",
                                         dl._DevicePrefetcher._launch)
    dl._DevicePrefetcher.__next__ = timed("wait",
                                          dl._DevicePrefetcher.__next__)
    gc.callbacks.append(on_gc)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cs._io_train(tmp, float("nan"))
    finally:
        gc.callbacks.remove(on_gc)
    print("io waits, in order: " + ", ".join(
        f"{name} {s * 1e3:.2f} ms" for name, s in events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
