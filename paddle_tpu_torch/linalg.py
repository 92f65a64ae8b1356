"""``paddle.linalg``: counterpart of ``paddle_tpu/linalg.py``, the
re-exports of ``tensor.linalg``."""

from .tensor.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, inv, lstsq, lu, matrix_power, matrix_rank, multi_dot, norm,
    pinv, qr, slogdet, solve, svd, triangular_solve)

__all__ = ["cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det",
           "eig", "eigh", "eigvals", "eigvalsh", "inv", "lstsq", "lu",
           "matrix_power", "matrix_rank", "multi_dot", "norm", "pinv", "qr",
           "slogdet", "solve", "svd", "triangular_solve"]
