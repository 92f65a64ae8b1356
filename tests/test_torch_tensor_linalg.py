"""Eager API parity, part 3: every public function of the JAX package's
``tensor/stat.py``, ``tensor/linalg.py`` (and the ``linalg`` namespace),
``tensor/random.py`` and ``tensor/einsum.py``, every operator and every
in-place method of the facade, against the JAX facade on the same numpy
inputs (f32 within rtol 1e-5 / atol 1e-6, the factorizations within
rtol 1e-4 / atol 1e-5; random draws by shape, dtype, range and
determinism under ``paddle.seed``, since the two packages' streams
differ)."""

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.linalg as jlinalg_ns
import paddle_tpu.tensor.einsum as jeinsum
import paddle_tpu.tensor.linalg as jlinalg
import paddle_tpu.tensor.random as jrandom
import paddle_tpu.tensor.stat as jstat
import paddle_tpu_torch as pp
import paddle_tpu_torch.linalg as plinalg_ns
import paddle_tpu_torch.tensor as ptensor
import paddle_tpu_torch.tensor.einsum as peinsum
import paddle_tpu_torch.tensor.linalg as plinalg
import paddle_tpu_torch.tensor.stat as pstat
from _torch_eager_cases import (F32, LOOSE, case, compare, eigh_post, f32,
                                ints, port_on_cpu, pos, reconstruct,  # noqa
                                rng, run_case, sorted_values, spd)

STAT = {
    "mean": lambda r: case(f32(r, 3, 4), axis=[0, 1]),
    "std": lambda r: case(f32(r, 3, 4), axis=1),
    "var": lambda r: case(f32(r, 3, 4), axis=0, unbiased=False,
                          keepdim=True),
    "median": lambda r: case(f32(r, 3, 4), axis=1),
    "nanmedian": lambda r: case(np.array([[1.0, np.nan, 3.0, 2.0]],
                                         np.float32), axis=1),
    "quantile": lambda r: case(f32(r, 3, 5), [0.25, 0.75], axis=1),
    "nanquantile": lambda r: case(np.array([[1.0, np.nan, 3.0, 2.0]],
                                           np.float32), 0.3, axis=1),
}


def _tri(r):
    return np.triu(f32(r, 4, 4)) + 4 * np.eye(4, dtype=np.float32)


LINALG = {
    "norm": lambda r: case(f32(r, 3, 4), p=2, axis=1),
    "matmul": lambda r: case(f32(r, 3, 4), f32(r, 4, 2)),
    "dist": lambda r: case(f32(r, 3, 4), f32(r, 3, 4), 3),
    "cond": lambda r: case(spd(r), tol=LOOSE),
    "cholesky": lambda r: case(spd(r), tol=LOOSE),
    "cholesky_solve": lambda r: case(
        f32(r, 4, 2), np.linalg.cholesky(spd(r)).astype(np.float32),
        tol=LOOSE),
    "svd": lambda r: case(f32(r, 4, 3), tol=LOOSE, post=reconstruct),
    "qr": lambda r: case(f32(r, 4, 3), tol=LOOSE, post=reconstruct),
    "lu": lambda r: case(spd(r), tol=LOOSE),
    "eig": lambda r: case(spd(r), tol=LOOSE, post=lambda o: [
        np.sort(o[0].real)]),
    "eigh": lambda r: case(spd(r), tol=LOOSE, post=eigh_post),
    "eigvals": lambda r: case(spd(r), tol=LOOSE, post=sorted_values),
    "eigvalsh": lambda r: case(spd(r), tol=LOOSE),
    "matrix_rank": lambda r: case(f32(r, 4, 2) @ f32(r, 2, 4)),
    "matrix_power": lambda r: case(f32(r, 3, 3), 3, tol=LOOSE),
    "det": lambda r: case(spd(r), tol=LOOSE),
    "slogdet": lambda r: case(spd(r), tol=LOOSE),
    "inv": lambda r: case(spd(r), tol=LOOSE),
    "inverse": lambda r: case(spd(r), tol=LOOSE),
    "pinv": lambda r: case(f32(r, 4, 3), tol=LOOSE),
    "solve": lambda r: case(spd(r), f32(r, 4, 2), tol=LOOSE),
    "triangular_solve": lambda r: case(_tri(r), f32(r, 4, 2), upper=True,
                                       tol=LOOSE),
    "lstsq": lambda r: case(f32(r, 5, 3), f32(r, 5, 2), tol=LOOSE,
                            post=lambda o: o[:1]),
    "multi_dot": lambda r: case([f32(r, 3, 4), f32(r, 4, 5), f32(r, 5, 2)],
                                tol=LOOSE),
    "cross": lambda r: case(f32(r, 4, 3), f32(r, 4, 3)),
    "histogram": lambda r: case(f32(r, 50), bins=5, min=-2, max=2),
    "bincount": lambda r: case(ints(r, 0, 6, 20), minlength=8),
    "mv": lambda r: case(f32(r, 3, 4), f32(r, 4)),
    "corrcoef": lambda r: case(f32(r, 3, 6), tol=LOOSE),
    "cov": lambda r: case(f32(r, 3, 6), tol=LOOSE),
    "bmm": lambda r: case(f32(r, 2, 3, 4), f32(r, 2, 4, 2)),
    "dot": lambda r: case(f32(r, 4), f32(r, 4)),
    "t": lambda r: case(f32(r, 3, 4)),
}


@pytest.mark.parametrize("name", jstat.__all__)
def test_stat_matches_jax(name):
    run_case(name, getattr(jstat, name), getattr(pstat, name),
             STAT[name](rng()))


@pytest.mark.parametrize("name", jlinalg.__all__ + ["bmm", "dot", "t"])
def test_linalg_matches_jax(name):
    run_case(name, getattr(jlinalg, name), getattr(plinalg, name),
             LINALG[name](rng()))


@pytest.mark.parametrize("name", jlinalg_ns.__all__)
def test_linalg_namespace_is_the_tensor_functions(name):
    assert getattr(plinalg_ns, name) is getattr(plinalg, name)


@pytest.mark.parametrize("equation,shapes", [
    ("ij,jk->ik", [(3, 4), (4, 5)]), ("bij,bjk", [(2, 3, 4), (2, 4, 2)]),
    ("ii->", [(4, 4)]), ("...i,i->...", [(2, 3, 4), (4,)])])
def test_einsum_matches_jax(equation, shapes):
    r = rng()
    run_case("einsum", jeinsum.einsum, peinsum.einsum,
             case(equation, *[f32(r, *s) for s in shapes]))


# -- random ----------------------------------------------------------------
def _draw(pkg, name):
    """One draw of ``name`` in ``pkg``: (output, (low, high) it must lie
    in, or None)."""
    x = pkg.to_tensor(np.full((3, 4), 0.5, np.float32))
    lam = pkg.to_tensor(np.full((3, 4), 3.0, np.float32))
    probs = pkg.to_tensor(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]],
                                   np.float32))
    calls = {
        "rand": (lambda: pkg.rand([3, 4]), (0, 1)),
        "randn": (lambda: pkg.randn([3, 4]), None),
        "randint": (lambda: pkg.randint(2, 9, [3, 4]), (2, 8)),
        "randint_like": (lambda: pkg.randint_like(x, 0, 5), (0, 4)),
        "randperm": (lambda: pkg.randperm(7), (0, 6)),
        "uniform": (lambda: pkg.uniform([3, 4], min=-2.0, max=3.0),
                    (-2, 3)),
        "normal": (lambda: pkg.normal(1.0, 2.0, [3, 4]), None),
        "standard_normal": (lambda: pkg.standard_normal([3, 4]), None),
        "bernoulli": (lambda: pkg.bernoulli(x), (0, 1)),
        "multinomial": (lambda: pkg.multinomial(probs, 2), (0, 2)),
        "poisson": (lambda: pkg.poisson(lam), (0, np.inf)),
        "uniform_": (lambda: pkg.to_tensor(
            np.zeros((3, 4), np.float32)).uniform_(0.0, 2.0), (0, 2)),
        "normal_": (lambda: pkg.to_tensor(
            np.zeros((3, 4), np.float32)).normal_(0.0, 1.0), None),
        "exponential_": (lambda: pkg.to_tensor(
            np.zeros((3, 4), np.float32)).exponential_(2.0), (0, np.inf)),
    }
    fn, rng_ = calls[name]
    return fn().numpy(), rng_


@pytest.mark.parametrize("name", jrandom.__all__)
def test_random_draws_match_jax_in_kind(name):
    """Same shape, dtype kind and range as the JAX draw; the same values
    again after ``paddle.seed`` with the same seed, other values after
    another seed (permutation and multinomial draws excepted, which may
    repeat), and ``randperm`` is a permutation."""
    jp.seed(3)
    if name == "poisson":
        # the JAX op raises under the package's own rbg keys (jax.random
        # draws poisson from threefry keys only): its contract is lam's
        # shape and floating dtype
        jout, bounds = np.zeros((3, 4), np.float32), (0, np.inf)
    else:
        jout, bounds = _draw(jp, name)
    pp.seed(3)
    a, _ = _draw(pp, name)
    assert a.shape == jout.shape and a.dtype.kind == jout.dtype.kind
    if bounds is not None:
        assert a.min() >= bounds[0] and a.max() <= bounds[1]
    pp.seed(3)
    b, _ = _draw(pp, name)
    np.testing.assert_array_equal(a, b)
    if name == "randperm":
        assert sorted(a.tolist()) == list(range(7))
    if name in ("randn", "standard_normal", "rand", "uniform", "normal"):
        pp.seed(4)
        c, _ = _draw(pp, name)
        assert not np.array_equal(a, c)


def test_rng_state_round_trip():
    """``set_rng_state(get_rng_state())`` replays the draws, in both
    packages, and the dropout stream with them in the port."""
    from paddle_tpu_torch.core.random import next_seed_words
    for pkg in (jp, pp):
        pkg.seed(9)
        pkg.randn([2])
        state = pkg.get_rng_state()
        a = pkg.randn([3]).numpy()
        pkg.set_rng_state(state)
        np.testing.assert_array_equal(pkg.randn([3]).numpy(), a)
    state = pp.get_rng_state()
    words = next_seed_words()
    pp.set_rng_state(state)
    assert next_seed_words() == words


# -- operators and in-place methods ------------------------------------------
def _operands(name):
    r = rng()
    if name in ("__and__", "__or__", "__xor__", "__invert__"):
        return f32(r, 3, 4) > 0, f32(r, 3, 4) > 0
    if name in ("__pow__", "__rpow__", "__truediv__", "__rtruediv__",
                "__floordiv__", "__rfloordiv__", "__mod__", "__rmod__"):
        return pos(r, 3, 4), pos(r, 3, 4)
    if name in ("__matmul__", "__rmatmul__"):
        return f32(r, 3, 3), f32(r, 3, 3)
    return f32(r, 3, 4), f32(r, 3, 4)


# a scalar operand of @ and of the logical operators has no meaning
_OPERATOR_CASES = [(n, o) for n in ptensor.DUNDERS for o in
                   ("tensor", "scalar")
                   if o == "tensor" or n not in (
                       "__matmul__", "__rmatmul__", "__and__", "__or__",
                       "__xor__")]


@pytest.mark.parametrize("name,other", _OPERATOR_CASES)
def test_operator_matches_jax(name, other):
    a, b = _operands(name)
    if other == "scalar":
        b = 1.5
    unary = name in ("__neg__", "__abs__", "__invert__")
    outs = []
    for pkg in (jp, pp):
        x = pkg.to_tensor(a)
        y = b if other == "scalar" else pkg.to_tensor(b)
        outs.append(getattr(x, name)() if unary else getattr(x, name)(y))
    compare(name, *outs, tol=F32)


@pytest.mark.parametrize("name", sorted(ptensor.INPLACE))
def test_inplace_method_matches_jax(name):
    """The method updates the tensor it is called on (rebinding it, as
    the JAX facade does) and returns it."""
    a = pos(rng(), 3, 4)
    args = {"add_": (0.5,), "subtract_": (0.5,), "multiply_": (2.0,),
            "scale_": (3.0,), "clip_": (0.6, 1.2), "fill_": (2.5,)}.get(
                name, ())
    outs = []
    for pkg in (jp, pp):
        x = pkg.to_tensor(a)
        ret = getattr(x, name)(*args)
        assert ret is x
        outs.append(x)
    compare(name, *outs, tol=F32)


def test_inplace_keeps_an_earlier_slice():
    """An in-place update rebinds: a slice taken before keeps its
    values, as in the JAX facade (a torch view would change)."""
    for pkg in (jp, pp):
        x = pkg.to_tensor(np.zeros((2, 3), np.float32))
        row = x[0]
        x.add_(1.0)
        x[1, 1] = 5.0
        np.testing.assert_array_equal(row.numpy(), [0, 0, 0])
        np.testing.assert_array_equal(x.numpy(), [[1, 1, 1], [1, 5, 1]])


def test_every_jax_method_is_on_the_facade():
    names = {n for n in dir(jp.Tensor) if not n.startswith("_")}
    missing = sorted(n for n in names if not hasattr(pp.Tensor, n))
    tail = set(jp.tensor.tail.__all__) | set(jp.tensor.sequence.__all__)
    assert [n for n in missing if n not in tail] == []
