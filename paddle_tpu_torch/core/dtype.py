"""Dtype registry: counterpart of ``paddle_tpu/core/dtype.py``.

Paddle's dtype names map onto torch dtypes here (the JAX package maps
them onto numpy's). :func:`convert_dtype` takes a name (``"float32"``,
``"bf16"``), a numpy dtype or scalar type, or a torch dtype, and returns
the torch dtype; ``None`` stays ``None``. A facade tensor's ``dtype`` is
the torch dtype, so ``x.dtype == paddle.float32`` holds in both
packages, but it prints ``torch.float32`` where the JAX package prints
``float32`` (:func:`dtype_to_str` gives the short name).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_to_str", "is_floating_point",
           "is_integer", "set_default_dtype", "get_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "half": float16, "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
}

_DTYPE2STR = {v: k for k, v in reversed(list(_STR2DTYPE.items()))}


def convert_dtype(dtype):
    """A name, numpy dtype / scalar type or torch dtype as a torch
    dtype (``None`` passes through)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _STR2DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unsupported dtype string: {dtype!r}")
    name = np.dtype(dtype).name
    try:
        return _STR2DTYPE[name]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dtype!r}")


def dtype_to_str(dtype) -> str:
    """Paddle's short name of ``dtype`` (``"float32"``)."""
    return _DTYPE2STR[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != bool_


_DEFAULT_DTYPE = [float32]


def set_default_dtype(dtype):
    _DEFAULT_DTYPE[0] = convert_dtype(dtype)


def get_default_dtype():
    return _DEFAULT_DTYPE[0]
