"""Linear algebra: counterpart of ``paddle_tpu/tensor/linalg.py``.

The JAX package's compositions, on ``torch.linalg``. ``lu`` returns
0-based pivots (``jax.scipy.linalg.lu_factor``'s; torch's are
LAPACK's 1-based); ``eig`` and ``eigvals`` go through the host as in
the JAX package; ``triangular_solve`` with ``transpose`` solves against
the transposed matrix's ``upper`` triangle, as the JAX composition does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._base import amp, axis_arg, float_of, like, tt, wrap

__all__ = [
    "norm", "matmul", "dist", "cond", "cholesky", "cholesky_solve", "svd",
    "qr", "lu", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
    "matrix_power", "det", "slogdet", "inv", "inverse", "pinv", "solve",
    "triangular_solve", "lstsq", "multi_dot", "cross", "histogram", "bincount",
    "mv", "corrcoef", "cov",
]

from .math import matmul  # noqa: E402,F401


def _norm(a, p, axis, keepdim):
    if axis is None:
        flat = a.reshape(-1)
        if p == "fro" or p == 2:
            return torch.sqrt(torch.sum(flat * flat))
        if p == 1:
            return torch.sum(flat.abs())
        if p == math.inf or p == "inf":
            return torch.max(flat.abs())
        if p == -math.inf:
            return torch.min(flat.abs())
        return torch.sum(flat.abs() ** p) ** (1.0 / p)
    ax = axis_arg(axis)
    if p == "fro":
        return torch.sqrt(torch.sum(a * a, dim=ax, keepdim=keepdim))
    if p == math.inf or p == "inf":
        return torch.amax(a.abs(), dim=ax, keepdim=keepdim)
    if p == -math.inf:
        return torch.amin(a.abs(), dim=ax, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=ax, keepdim=keepdim)
    return torch.sum(a.abs() ** p, dim=ax, keepdim=keepdim) ** (1.0 / p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    a, = amp("norm", tt(x))
    return wrap(_norm(float_of(a), p, axis, keepdim))


def dist(x, y, p=2, name=None):
    a = tt(x)
    return norm(wrap(a - like(y, a)),
                p=float(p) if p not in ("fro", "inf") else p)


def cond(x, p=None, name=None):
    a = tt(x)
    p = p or 2
    if p == 2:
        s = torch.linalg.svdvals(a)
        return wrap(s[..., 0] / s[..., -1])
    return wrap(torch.linalg.matrix_norm(a, ord=p)
                * torch.linalg.matrix_norm(torch.linalg.inv(a), ord=p))


def cholesky(x, upper=False, name=None):
    return wrap(torch.linalg.cholesky(tt(x), upper=upper))


def cholesky_solve(x, y, upper=False, name=None):
    b = tt(x)
    return wrap(torch.cholesky_solve(b, like(y, b), upper=upper))


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(tt(x), full_matrices=full_matrices)
    return wrap(u), wrap(s), wrap(vh)


def qr(x, mode="reduced", name=None):
    out = torch.linalg.qr(tt(x), mode=mode)
    if mode == "r":
        return wrap(out[1])
    return wrap(out[0]), wrap(out[1])


def lu(x, pivot=True, get_infos=False, name=None):
    a = tt(x)
    lu_mat, piv = torch.linalg.lu_factor(a, pivot=pivot)
    outs = (wrap(lu_mat), wrap((piv - 1).to(torch.int32)))
    if get_infos:
        return outs + (wrap(torch.zeros((), dtype=torch.int32,
                                        device=a.device)),)
    return outs


def _host_eig(x, fn):
    a = tt(x)
    out = fn(a.detach().cpu().numpy())
    out = out if isinstance(out, tuple) else (out,)
    res = tuple(wrap(torch.from_numpy(np.asarray(o)).to(a.device))
                for o in out)
    return res if len(res) > 1 else res[0]


def eig(x, name=None):
    return _host_eig(x, lambda a: tuple(np.linalg.eig(a)))


def eigvals(x, name=None):
    return _host_eig(x, np.linalg.eigvals)


def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(tt(x), UPLO=UPLO)
    return wrap(w), wrap(v)


def eigvalsh(x, UPLO="L", name=None):
    return wrap(torch.linalg.eigvalsh(tt(x), UPLO=UPLO))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return wrap(torch.linalg.matrix_rank(tt(x), rtol=tol,
                                         hermitian=hermitian))


def matrix_power(x, n, name=None):
    return wrap(torch.linalg.matrix_power(tt(x), n))


def det(x, name=None):
    return wrap(torch.linalg.det(tt(x)))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(tt(x))
    return wrap(torch.stack([sign, logdet]))


def inv(x, name=None):
    return wrap(torch.linalg.inv(tt(x)))


inverse = inv


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return wrap(torch.linalg.pinv(tt(x), rtol=rcond, hermitian=hermitian))


def solve(x, y, name=None):
    a = tt(x)
    return wrap(torch.linalg.solve(a, like(y, a)))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = tt(x)
    a2 = a.transpose(-1, -2) if transpose else a
    return wrap(torch.linalg.solve_triangular(
        a2, like(y, a), upper=upper, unitriangular=unitriangular))


def lstsq(x, y, rcond=None, driver=None, name=None):
    a = tt(x)
    out = torch.linalg.lstsq(a, like(y, a), rcond=rcond,
                             driver=driver or ("gelsd" if a.device.type ==
                                               "cpu" else None))
    return (wrap(out.solution), wrap(out.residuals), wrap(out.rank),
            wrap(out.singular_values))


def multi_dot(x, name=None):
    return wrap(torch.linalg.multi_dot([tt(i) for i in x]))


def cross(x, y, axis=9, name=None):
    a = tt(x)
    ax = axis
    if ax == 9:
        ax = next(i for i, d in enumerate(a.shape) if d == 3)
    return wrap(torch.linalg.cross(a, like(y, a), dim=ax))


def histogram(input, bins=100, min=0, max=0, name=None):
    a = float_of(tt(input))
    if min == 0 and max == 0:
        lo, hi = float(a.min()), float(a.max())
    else:
        lo, hi = float(min), float(max)
    return wrap(torch.histc(a, bins=bins, min=lo, max=hi).to(torch.int64))


def bincount(x, weights=None, minlength=0, name=None):
    a = tt(x)
    w = None if weights is None else like(weights, a)
    return wrap(torch.bincount(a, weights=w, minlength=minlength))


def mv(x, vec, name=None):
    a = tt(x)
    return wrap(torch.matmul(a, like(vec, a)))


def corrcoef(x, rowvar=True, name=None):
    a = tt(x)
    return wrap(torch.corrcoef(a if rowvar else a.t()))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a = tt(x)
    return wrap(torch.cov(a if rowvar else a.t(),
                          correction=1 if ddof else 0))


from .math import bmm, dot, t  # noqa: E402,F401
