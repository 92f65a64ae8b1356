"""Readings of ``chip_smoke.py``'s amp_int8 witness, sound and with
planted faults: the measurement behind its ``AMP_INT8_GRAD_TOL``.

The witness runs O1 ``TrainStep`` steps of GPT-2 345M at phase 7's
configuration under ``FLAGS_amp_int8_matmul`` and holds each step's
loss and gradients against a replay with every kernel wrapper swapped
for its plain version. The int8 quantization of the MLP inputs turns
the flash kernel's last bits into whole int8 quanta, so the sound
gradient error is well above float noise. This script prints that
error for ``--steps`` steps on each of ``--seeds`` batches, then for the
first step on batch 0 with one fault planted in a kernel wrapper on the
kernel side only (the replay swaps the wrapper for its plain version):

- ``flash fwd without dropout``: the flash forward drops its dropout;
- ``flash bwd without dropout``: the flash backward drops it;
- ``flash other mask``: forward and backward agree on a dropout mask
  drawn from other seed words than the plain version's;
- ``dropout other mask``: the same for the fused dropout kernel.

It needs one card and runs from the root of a checkout::

    python3 tools/amp_int8_witness_spread.py [--seeds 4] [--steps 3]

The last line is one JSON object with every reading, the card's name
and its power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import inspect
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


@contextlib.contextmanager
def _planted(module, name, change):
    """Inside the block ``module.name`` calls the wrapper with its bound
    arguments passed through ``change`` first."""
    orig = getattr(module, name)
    sig = inspect.signature(orig)

    def faulty(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        change(bound.arguments)
        return orig(*bound.args, **bound.kwargs)

    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _other_words(args):
    if args["seed_words"] is not None:
        w0, w1 = args["seed_words"]
        args["seed_words"] = ((w0 + 1) & 0xFFFFFFFF, w1)


def _no_dropout(args):
    args["dropout_rate"] = 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("amp_int8_witness_spread.py needs a CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import dropout as dr
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    kernels.build()
    inf = math.inf
    refs = (("plain", None, inf, inf),)

    def run(tag, seed, steps, fault=contextlib.nullcontext):
        cfg, _, loss_fn, step, ids, labels = cs._train_setup(amp=True)
        if seed:
            rng = np.random.default_rng(seed)
            ids, labels = (rng.integers(0, cfg.vocab_size, ids.shape)
                           .astype(np.int32) for _ in range(2))
        readings = []
        with flag_scope("amp_int8_matmul", True), fault():
            cs._witness(tag, step, loss_fn, (ids, labels), steps,
                        refs=refs, readings=readings)
        del step
        gc.collect()
        torch.cuda.empty_cache()
        return [{"seed": seed, "step": t, "loss_err": le, "grad_err": ge}
                for _, t, le, ge in readings]

    sound = []
    for seed in range(a.seeds):
        sound += run(f"sound seed {seed}", seed, a.steps)

    @contextlib.contextmanager
    def flash_other_mask():
        with _planted(fa, "flash_attention_fwd", _other_words), \
                _planted(fa, "flash_attention_bwd", _other_words):
            yield

    faults = {
        "flash fwd without dropout":
            lambda: _planted(fa, "flash_attention_fwd", _no_dropout),
        "flash bwd without dropout":
            lambda: _planted(fa, "flash_attention_bwd", _no_dropout),
        "flash other mask": flash_other_mask,
        "dropout other mask":
            lambda: _planted(dr, "dropout_apply", _other_words),
    }
    planted = {name: run(name, 0, 1, fault)[0]
               for name, fault in faults.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    worst = max(r["grad_err"] for r in sound)
    least = min(r["grad_err"] for r in planted.values())
    print(f"sound gradient error: max {worst:.3e} over {len(sound)} steps; "
          f"planted faults: least {least:.3e}; chip_smoke.py's "
          f"AMP_INT8_GRAD_TOL {cs.AMP_INT8_GRAD_TOL:g}")
    print(json.dumps({"card": card, "sound": sound, "planted": planted,
                      "amp_int8_grad_tol": cs.AMP_INT8_GRAD_TOL}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
