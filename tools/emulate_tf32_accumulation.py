#!/usr/bin/env python3
"""Emulate, in numpy on the CPU, the error of the f32 flash backward's
long sums on the tensor cores: dv = pv^T dO and dk = ds^T q over the
queries, dq = ds k over the keys, each as mma.sync m16n8k8 tf32 computes
it by the 3xTF32 split (``paddle_tpu_torch/csrc/mma_tf32.cuh``): per k
step of 8, three products (small . big, big . small, big . big) of the
split operands, each summed exactly and added to the accumulator.

The accumulator's add is emulated rounding toward zero, the way the
tensor cores' f32 accumulation truncates, and the sum is kept either
in one running accumulator (``chain``) or, per ``fresh`` k steps, from
zero and then added to the running sum rounded to nearest (what
``mma_3xtf32_rn`` does per k step). Inputs: one head of causal attention
at S = 1024, D = 64 from ``np.random.default_rng(0)``; p, dp and ds
exact (float64), then rounded to f32. Prints, for each product, the max
abs error against the float64 product over its largest magnitude. Run::

    python3 tools/emulate_tf32_accumulation.py
"""

from __future__ import annotations

import numpy as np

S, D = 1024, 64


def tf32(x):
    """Round to the nearest tf32, ties away (the kernels' integer form)."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def split(x):
    x = x.astype(np.float32)
    big = tf32(x)
    return big, tf32((x - big).astype(np.float32))


def toward_zero(x):
    """float64 -> float32, rounding toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def product(a, b, fresh: int):
    """a b by 3xTF32 k steps of 8, accumulated as described above;
    ``fresh`` 0 keeps one running accumulator."""
    ab, as_ = split(a)
    bb, bs = split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(total)
    steps = a.shape[1] // 8
    for i in range(steps):
        sl = slice(8 * i, 8 * i + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            part = toward_zero(part.astype(np.float64)
                               + x[:, sl].astype(np.float64)
                               @ y[sl].astype(np.float64))
        if fresh and ((i + 1) % fresh == 0 or i + 1 == steps):
            total = (total.astype(np.float64) + part).astype(np.float32)
            part = np.zeros_like(total)
    return total if fresh else part


def main() -> None:
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((S, D)).astype(np.float32)
                   for _ in range(4))
    s = q.astype(np.float64) @ k.T.astype(np.float64) / np.sqrt(D)
    s[~np.tril(np.ones((S, S), bool))] = -np.inf
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = do.astype(np.float64) @ v.T.astype(np.float64)
    delta = (do.astype(np.float64) * (p @ v.astype(np.float64))).sum(
        1, keepdims=True)
    ds = (p * (dp - delta) / np.sqrt(D)).astype(np.float32)
    p = p.astype(np.float32)
    print("product  chain      fresh 1    fresh 2    fresh 4")
    for name, a, b in (("dv", p.T.copy(), do), ("dk", ds.T.copy(), q),
                       ("dq", ds, k)):
        exact = a.astype(np.float64) @ b.astype(np.float64)
        errs = [np.abs(product(a, b, f) - exact).max() / np.abs(exact).max()
                for f in (0, 1, 2, 4)]
        print(f"{name:8s} " + "  ".join(f"{e:.3e}" for e in errs))


if __name__ == "__main__":
    main()
