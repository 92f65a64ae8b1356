"""Model summary: counterpart of ``paddle_tpu/hapi/summary.py``. One row
a layer that owns parameters (or has no children), by its qualified
name (the top layer by its class), with its parameter count; the totals
count every parameter, the trainable ones those with ``requires_grad``.
Prints the table and returns the two totals."""

from __future__ import annotations

import numpy as np


def summary(net, input_size=None, dtypes=None):
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer in net.named_modules():
        n_params = sum(int(np.prod(p.shape)) if p.shape else 1
                       for p in layer._parameters.values() if p is not None)
        if n_params or not layer._modules:
            rows.append((name or type(net).__name__, type(layer).__name__,
                         n_params))
    for _, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total_params += n
        if p.requires_grad:
            trainable_params += n
    lines = [f"{'Layer':<46}{'Type':<26}{'Params':>12}", "-" * 84]
    for name, tname, n in rows:
        lines.append(f"{name:<46}{tname:<26}{n:>12,}")
    lines += ["-" * 84,
              f"Total params: {total_params:,}",
              f"Trainable params: {trainable_params:,}"]
    out = "\n".join(lines)
    print(out)
    return {"total_params": total_params, "trainable_params": trainable_params}
