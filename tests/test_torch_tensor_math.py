"""Eager API parity, part 1: every public function of the JAX package's
``tensor/creation.py`` and ``tensor/math.py`` against the port's, on the
same numpy inputs (f32 within rtol 1e-5 / atol 1e-6 unless a case says
otherwise; integers and booleans exact)."""

import numpy as np
import pytest

import paddle_tpu.tensor.creation as jcreation
import paddle_tpu.tensor.math as jmath
import paddle_tpu_torch as pp
import paddle_tpu_torch.tensor.creation as pcreation
import paddle_tpu_torch.tensor.math as pmath
from _torch_eager_cases import (LOOSE, case, f32, ints, port_on_cpu,  # noqa
                                pos, rng, run_case, unit)

CREATION = {
    "to_tensor": lambda r: case(f32(r, 2, 3)),
    "zeros": lambda r: case([2, 3]),
    "ones": lambda r: case([2, 3], dtype="int32"),
    "full": lambda r: case([2, 3], 7.0),
    "zeros_like": lambda r: case(f32(r, 2, 3)),
    "ones_like": lambda r: case(f32(r, 2, 3)),
    "full_like": lambda r: case(f32(r, 2, 3), 3.5),
    "arange": lambda r: case(1, 11, 3),
    "linspace": lambda r: case(0.0, 1.0, 7),
    "eye": lambda r: case(3, 4),
    "empty": lambda r: case([2, 2]),
    "empty_like": lambda r: case(f32(r, 2, 3)),
    "diag": lambda r: case(f32(r, 3), 1, padding_value=0.5),
    "diagflat": lambda r: case(f32(r, 3), -1),
    "tril": lambda r: case(f32(r, 3, 4), -1),
    "triu": lambda r: case(f32(r, 3, 4), 1),
    "meshgrid": lambda r: case(f32(r, 3), f32(r, 4)),
    "assign": lambda r: case(f32(r, 2, 3)),
    "clone": lambda r: case(f32(r, 2, 3)),
    "numel": lambda r: case(f32(r, 2, 3)),
    "complex": lambda r: case(f32(r, 2, 3), f32(r, 2, 3)),
    "real": lambda r: case((f32(r, 3) + 1j * f32(r, 3)).astype(np.complex64)),
    "imag": lambda r: case((f32(r, 3) + 1j * f32(r, 3)).astype(np.complex64)),
}


def _unary(kind="any"):
    make = {"any": f32, "pos": pos, "unit": unit}[kind]
    return lambda r: case(make(r, 3, 4))


MATH = {
    "add": lambda r: case(f32(r, 3, 4), f32(r, 4)),
    "subtract": lambda r: case(f32(r, 3, 4), 2.5),
    "multiply": lambda r: case(f32(r, 3, 4), f32(r, 3, 4)),
    "divide": lambda r: case(f32(r, 3, 4), pos(r, 3, 4)),
    "floor_divide": lambda r: case(f32(r, 3, 4) * 4, pos(r, 3, 4)),
    "remainder": lambda r: case(f32(r, 3, 4) * 4, pos(r, 3, 4)),
    "mod": lambda r: case(ints(r, -9, 9, 3, 4), ints(r, 1, 4, 3, 4)),
    "pow": lambda r: case(pos(r, 3, 4), f32(r, 3, 4)),
    "matmul": lambda r: case(f32(r, 3, 4), f32(r, 5, 4), transpose_y=True),
    "mm": lambda r: case(f32(r, 3, 4), f32(r, 4, 5)),
    "bmm": lambda r: case(f32(r, 2, 3, 4), f32(r, 2, 4, 5)),
    "dot": lambda r: case(f32(r, 3, 4), f32(r, 3, 4)),
    "inner": lambda r: case(f32(r, 3, 4), f32(r, 5, 4)),
    "outer": lambda r: case(f32(r, 3), f32(r, 4)),
    "t": lambda r: case(f32(r, 3, 4)),
    "transpose_": lambda r: case(f32(r, 2, 3, 4), [2, 0, 1]),
    "scale": lambda r: case(f32(r, 3, 4), 2.0, 1.0, False),
    "abs": _unary(), "neg": _unary(), "exp": _unary(),
    "expm1": _unary(), "log": _unary("pos"), "log2": _unary("pos"),
    "log10": _unary("pos"), "log1p": _unary("pos"), "sqrt": _unary("pos"),
    "rsqrt": _unary("pos"), "square": _unary(),
    "reciprocal": _unary("pos"), "sign": _unary(), "floor": _unary(),
    "ceil": _unary(), "round": lambda r: case(f32(r, 3, 4) * 3),
    "trunc": lambda r: case(f32(r, 3, 4) * 3), "sin": _unary(),
    "cos": _unary(), "tan": _unary("unit"), "asin": _unary("unit"),
    "acos": _unary("unit"), "atan": _unary(), "sinh": _unary(),
    "cosh": _unary(), "tanh": _unary(), "asinh": _unary(),
    "acosh": lambda r: case(pos(r, 3, 4) + 1), "atanh": _unary("unit"),
    "atan2": lambda r: case(f32(r, 3, 4), f32(r, 3, 4)),
    "erf": _unary(), "erfinv": _unary("unit"),
    "lgamma": lambda r: case(pos(r, 3, 4), tol=LOOSE),
    "digamma": lambda r: case(pos(r, 3, 4), tol=LOOSE),
    "sum": lambda r: case(f32(r, 3, 4), axis=1),
    "mean": lambda r: case(f32(r, 3, 4), axis=0, keepdim=True),
    "max": lambda r: case(f32(r, 3, 4), axis=1),
    "min": lambda r: case(f32(r, 3, 4)),
    "prod": lambda r: case(f32(r, 3, 4), axis=1, keepdim=True),
    "amax": lambda r: case(f32(r, 2, 3, 4), axis=[0, 2]),
    "amin": lambda r: case(f32(r, 3, 4), axis=0),
    "logsumexp": lambda r: case(f32(r, 3, 4), axis=1),
    "cumsum": lambda r: case(f32(r, 3, 4), axis=1),
    "cumprod": lambda r: case(f32(r, 3, 4), dim=0),
    "clip": lambda r: case(f32(r, 3, 4), -0.5, 0.5),
    "maximum": lambda r: case(f32(r, 3, 4), f32(r, 3, 4)),
    "minimum": lambda r: case(f32(r, 3, 4), f32(r, 4)),
    "fmax": lambda r: case(np.array([1.0, np.nan, 3.0], np.float32),
                           np.array([np.nan, 2.0, 1.0], np.float32)),
    "fmin": lambda r: case(np.array([1.0, np.nan, 3.0], np.float32),
                           np.array([np.nan, 2.0, 1.0], np.float32)),
    "add_n": lambda r: case([f32(r, 3, 4), f32(r, 3, 4), f32(r, 3, 4)]),
    "multiplex": lambda r: case([f32(r, 3, 4), f32(r, 3, 4)],
                                np.array([[0], [1], [0]], np.int32)),
    "isnan": lambda r: case(np.array([1.0, np.nan, np.inf], np.float32)),
    "isinf": lambda r: case(np.array([1.0, np.nan, -np.inf], np.float32)),
    "isfinite": lambda r: case(np.array([1.0, np.nan, np.inf], np.float32)),
    "nan_to_num": lambda r: case(np.array([1.0, np.nan, np.inf, -np.inf],
                                          np.float32), nan=0.5, posinf=9.0,
                                 neginf=-9.0),
    "stanh": _unary(),
    "kron": lambda r: case(f32(r, 2, 2), f32(r, 2, 3)),
    "trace": lambda r: case(f32(r, 3, 4), 1),
    "all": lambda r: case(f32(r, 3, 4) > -1, axis=1),
    "any": lambda r: case(f32(r, 3, 4) > 1),
    "broadcast_shape": lambda r: case([2, 1, 3], [4, 3]),
    "lerp": lambda r: case(f32(r, 3, 4), f32(r, 3, 4), 0.3),
    "rad2deg": _unary(), "deg2rad": _unary(),
    "gcd": lambda r: case(ints(r, 1, 30, 3, 4), ints(r, 1, 30, 3, 4)),
    "lcm": lambda r: case(ints(r, 1, 30, 3, 4), ints(r, 1, 30, 3, 4)),
    "diff": lambda r: case(f32(r, 3, 4), axis=1),
    "angle": lambda r: case((f32(r, 3) + 1j * f32(r, 3))
                            .astype(np.complex64)),
    "frac": lambda r: case(f32(r, 3, 4) * 3),
    "count_nonzero": lambda r: case(ints(r, 0, 2, 3, 4), axis=1),
    "nansum": lambda r: case(np.array([[1.0, np.nan], [2.0, 3.0]],
                                      np.float32), axis=1),
    "nanmean": lambda r: case(np.array([[1.0, np.nan], [2.0, 3.0]],
                                       np.float32), axis=1),
    "heaviside": lambda r: case(np.array([-1.0, 0.0, 2.0], np.float32),
                                np.array([0.5, 0.5, 0.5], np.float32)),
    "logit": lambda r: case((np.random.default_rng(1).random((3, 4)))
                            .astype(np.float32), eps=1e-3),
    "increment": lambda r: case(f32(r, 1), 2.0),
}


@pytest.mark.parametrize("name", jcreation.__all__)
def test_creation_matches_jax(name):
    run_case(name, getattr(jcreation, name), getattr(pcreation, name),
             CREATION[name](rng()))


@pytest.mark.parametrize("name", jmath.__all__)
def test_math_matches_jax(name):
    run_case(name, getattr(jmath, name), getattr(pmath, name),
             MATH[name](rng()))


def test_to_tensor_rules():
    """numpy float64 lands as float32, an explicit dtype is kept, Python
    ints are int64 (int32 in the JAX package), and ``place`` names the
    device."""
    t = pp.to_tensor(np.arange(3, dtype=np.float64))
    assert t.dtype == pp.float32 and t.shape == [3]
    assert pp.to_tensor([1.0], dtype="float64").dtype == pp.float64
    assert pp.to_tensor([1, 2]).dtype == pp.int64
    assert str(pp.to_tensor([1.0], place="cpu").place) == "Place(cpu:0)"
    assert pp.to_tensor([1.0]).stop_gradient
    assert not pp.to_tensor([1.0], stop_gradient=False).stop_gradient
