"""Shared parity machinery for the eager API tests (``test_torch_tensor_*``,
``test_torch_autograd``, ``test_torch_layer``, ``test_torch_eager``):
one case per public function of the JAX package's ``tensor`` modules,
run on the same numpy inputs through the JAX facade and the port's.

A case is ``(args, kwargs)`` built from a seeded numpy generator; a
numpy array becomes a tensor of each package (a list of arrays, a list
of tensors), anything else goes as it is. Outputs are compared as
numpy arrays: same shape, values within the case's tolerance, and the
same dtype kind (the port keeps int64 where the JAX package, with x64
off, has int32: ``ROADMAP.md`` Queue 3). ``post`` maps an output to what
is compared where the two are equal only up to a convention (a
singular vector's sign: the reconstruction is compared). This module
imports the JAX package only inside :func:`run_case`, so that a test
file whose card cases run without JAX can take its fixture.
"""

from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu_torch as pp
from paddle_tpu_torch.core import device as pdevice
from paddle_tpu_torch.core import random as prandom

F32 = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port's default device is the CPU for the test, and its
    default device and eager generators are restored after it."""
    saved = list(pdevice._DEFAULT_DEVICE)
    state = dict(prandom._EAGER)
    pp.set_device("cpu")
    yield
    pdevice._DEFAULT_DEVICE[:] = saved
    prandom._EAGER.update(state)


def rng():
    return np.random.default_rng(0)


def f32(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def pos(r, *shape):
    return (r.random(shape) + 0.5).astype(np.float32)


def unit(r, *shape):
    return (r.random(shape) * 1.8 - 0.9).astype(np.float32)


def ints(r, lo, hi, *shape):
    return r.integers(lo, hi, shape).astype(np.int64)


def spd(r, n=4):
    a = f32(r, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def to_pkg(pkg, x):
    if isinstance(x, np.ndarray):
        return pkg.to_tensor(x)
    if isinstance(x, (list, tuple)) and x and all(
            isinstance(e, np.ndarray) for e in x):
        return type(x)(pkg.to_tensor(e) for e in x)
    return x


def flat(out) -> list:
    """An op's outputs as numpy arrays (tensors, tuples and lists of
    them, Python values)."""
    if isinstance(out, (list, tuple)) and (not out or hasattr(
            out[0], "numpy") or isinstance(out[0], (list, tuple))):
        return [a for o in out for a in flat(o)]
    if hasattr(out, "numpy"):
        return [np.asarray(out.numpy())]
    return [np.asarray(out)]


def kind(a: np.ndarray) -> str:
    k = a.dtype.kind
    return "i" if k == "u" else k


def compare(name, jout, pout, tol=F32, post=None):
    j, p = flat(jout), flat(pout)
    if post is not None:
        j, p = post(j), post(p)
    assert len(j) == len(p), f"{name}: {len(j)} outputs vs {len(p)}"
    for i, (a, b) in enumerate(zip(j, p)):
        assert a.shape == b.shape, f"{name}[{i}]: {a.shape} vs {b.shape}"
        assert kind(a) == kind(b), f"{name}[{i}]: {a.dtype} vs {b.dtype}"
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(b, a, err_msg=f"{name}[{i}]", **tol)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{i}]")


def run_case(name, jfn, pfn, case):
    import paddle_tpu as jp
    args, kwargs, tol, post = case
    jout = jfn(*[to_pkg(jp, a) for a in args], **kwargs)
    pout = pfn(*[to_pkg(pp, a) for a in args], **kwargs)
    compare(name, jout, pout, tol, post)


def case(*args, tol=F32, post=None, **kwargs):
    return (args, kwargs, tol, post)


def sorted_values(outs):
    return [np.sort_complex(o.ravel()) if o.dtype.kind == "c"
            else np.sort(o.ravel()) for o in outs]


def reconstruct(outs):
    """``u, s, vh`` (or ``q, r``) compared through the matrix they
    rebuild and the singular values."""
    if len(outs) == 3:
        u, s, vh = outs
        return [(u * s[..., None, :]) @ vh, s]
    q, r = outs
    return [q @ r, np.abs(np.diagonal(r, axis1=-2, axis2=-1))]


def eigh_post(outs):
    w, v = outs
    return [w, np.abs(v)]
