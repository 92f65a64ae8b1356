"""AMP autocast: the JAX package's O1 op lists, applied by name.

Counterpart of ``paddle_tpu/amp/auto_cast.py`` (:28-121) at level O1
with bfloat16, the case the training path runs: the white and black
lists are copied, and :func:`cast_inputs` applies the O1 rule of
``_cast_target``. The JAX package casts the floating inputs of a named
op inside its dispatch layer; the port's model calls :func:`cast_inputs`
with the same op names at the same places, so the two packages round at
the same points. Other levels, float16 and non-empty custom lists are
not ported (they raise): every kernel of the port takes float32 or
bfloat16 only. ``enable=False`` and ``amp_guard`` are.

``torch.autocast`` is not used: its op lists differ (it never casts
``embedding``, and its ``layer_norm`` returns float32), so the residual
stream would take other dtypes than the JAX model's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

__all__ = ["white_list", "black_list", "auto_cast", "amp_guard",
           "cast_inputs", "is_active"]

# Ops whose inputs are cast to low precision in O1 (matmul-class ops;
# `embedding` so the activation stream starts in low precision)
white_list = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "scaled_dot_product_attention", "einsum", "embedding",
    "fused_qkv", "attn_out", "mlm_head", "ernie_mlm_head", "lm_logits",
}

# Ops whose inputs are cast to float32 (numerically sensitive);
# `layer_norm` is absent on purpose: it computes in f32 and returns its
# input dtype
black_list = {
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "group_norm", "instance_norm", "norm",
    "mean", "sum", "exp", "log", "logsumexp", "erf", "erfinv", "pow",
    "cumsum", "rsqrt", "sqrt", "square",
}

# Never cast: ``batch_norm`` computes its statistics in f32 and returns
# its input's dtype, and a cast would round its f32 running-stat buffers
# through bf16; ``fused_conv_bn`` casts its conv operands itself
# (``nn.functional_vision``), the JAX package's ``_keep_dtype`` (:56)
_keep_dtype = {"batch_norm", "fused_conv_bn"}

_tls = threading.local()


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16") -> Iterator[None]:
    """``paddle.amp.auto_cast(enable=True, custom_white_list=None,
    custom_black_list=None, level="O1", dtype="bfloat16")``, the JAX
    package's signature (:85): inside an enabled block,
    :func:`cast_inputs` casts the inputs of listed ops; inside
    ``enable=False`` nothing is cast, also within an enclosing enabled
    block, as the JAX package's disabled state does."""
    if enable:
        if level != "O1" or dtype != "bfloat16":
            raise NotImplementedError(
                f"only level='O1' with dtype='bfloat16' is ported, got "
                f"level={level!r}, dtype={dtype!r}")
        if custom_white_list or custom_black_list:
            raise NotImplementedError(
                "custom white and black lists are not ported")
    prev = getattr(_tls, "active", False)
    _tls.active = bool(enable)
    try:
        yield
    finally:
        _tls.active = prev


amp_guard = auto_cast


def is_active() -> bool:
    """True inside an :func:`auto_cast` block."""
    return getattr(_tls, "active", False)


def _cast_target(op_name: str) -> Optional[torch.dtype]:
    """Target dtype for the op's floating inputs, or None (leave them)."""
    if not is_active() or op_name in _keep_dtype:
        return None
    if op_name in white_list:
        return torch.bfloat16
    if op_name in black_list:
        return torch.float32
    return None


def cast_inputs(op_name: str, *tensors):
    """The op's inputs under the active policy: floating tensors cast to
    the target dtype, anything else as given. Returns a tuple."""
    target = _cast_target(op_name)
    if target is None:
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != target else t
                 for t in tensors)
