"""einsum: counterpart of ``paddle_tpu/tensor/einsum.py`` (explicit and
implicit forms, ellipsis broadcasting, traces and reductions), on
``torch.einsum``, with the AMP cast of the ``einsum`` op."""

from __future__ import annotations

import torch

from ._base import amp, tt, wrap

__all__ = ["einsum"]


def einsum(equation: str, *operands):
    return wrap(torch.einsum(equation, *amp("einsum", *[tt(o) for o in
                                                        operands])))
