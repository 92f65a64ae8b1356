"""Eager API parity, part 2: every public function of the JAX package's
``tensor/manipulation.py``, ``tensor/logic.py`` and ``tensor/search.py``
against the port's, on the same numpy inputs (f32 within rtol 1e-5 /
atol 1e-6; integers, booleans and indices exact)."""

import numpy as np
import pytest

import paddle_tpu.tensor.logic as jlogic
import paddle_tpu.tensor.manipulation as jmanip
import paddle_tpu.tensor.search as jsearch
import paddle_tpu_torch as pp
import paddle_tpu_torch.tensor.logic as plogic
import paddle_tpu_torch.tensor.manipulation as pmanip
import paddle_tpu_torch.tensor.search as psearch
from _torch_eager_cases import (case, f32, ints, port_on_cpu,  # noqa: F401
                                rng, run_case)


def _i(*rows):
    return np.array(rows, np.int64)


MANIPULATION = {
    "reshape": lambda r: case(f32(r, 2, 3, 4), [6, 4]),
    "flatten": lambda r: case(f32(r, 2, 3, 4), 1, 2),
    "transpose": lambda r: case(f32(r, 2, 3, 4), [2, 0, 1]),
    "squeeze": lambda r: case(f32(r, 3, 1, 4, 1), axis=[1, 2]),
    "unsqueeze": lambda r: case(f32(r, 3, 4), [0, 2]),
    "concat": lambda r: case([f32(r, 3, 4), f32(r, 3, 2)], axis=1),
    "stack": lambda r: case([f32(r, 3, 4), f32(r, 3, 4)], axis=1),
    "unstack": lambda r: case(f32(r, 3, 4), axis=1),
    "split": lambda r: case(f32(r, 2, 6, 3), [1, -1, 2], axis=1),
    "chunk": lambda r: case(f32(r, 2, 6), 3, axis=1),
    "tile": lambda r: case(f32(r, 2, 3), [2, 1, 2]),
    "expand": lambda r: case(f32(r, 1, 3), [4, -1]),
    "expand_as": lambda r: case(f32(r, 1, 3), f32(r, 4, 3)),
    "broadcast_to": lambda r: case(f32(r, 1, 3), [2, 4, 3]),
    "gather": lambda r: case(f32(r, 5, 3), _i(0, 2, 4, 2), axis=0),
    "gather_nd": lambda r: case(f32(r, 2, 3, 4), _i([0, 1], [1, 2])),
    "scatter": lambda r: case(f32(r, 5, 3), _i(1, 3), f32(r, 2, 3),
                              overwrite=False),
    "scatter_nd": lambda r: case(_i([1], [3], [1]), f32(r, 3, 3), [5, 3]),
    "scatter_nd_add": lambda r: case(f32(r, 5, 3), _i([1], [3], [1]),
                                     f32(r, 3, 3)),
    "index_select": lambda r: case(f32(r, 3, 5), _i(4, 0), axis=1),
    "index_sample": lambda r: case(f32(r, 3, 5), _i([0, 4], [1, 1],
                                                    [3, 2])),
    "take_along_axis": lambda r: case(f32(r, 3, 5), _i([0, 4], [1, 1],
                                                       [3, 2]), 1),
    "put_along_axis": lambda r: case(f32(r, 3, 5), _i([0, 4], [1, 2],
                                                      [3, 2]),
                                     f32(r, 3, 2), 1, reduce="add"),
    "roll": lambda r: case(f32(r, 3, 4), 2, axis=1),
    "flip": lambda r: case(f32(r, 3, 4), [0, 1]),
    "rot90": lambda r: case(f32(r, 3, 4), 1, [0, 1]),
    "unique": lambda r: case(ints(r, 0, 5, 12), return_index=True,
                             return_inverse=True, return_counts=True),
    "unique_consecutive": lambda r: case(_i(1, 1, 2, 2, 2, 3, 1, 1),
                                         return_inverse=True,
                                         return_counts=True),
    "unbind": lambda r: case(f32(r, 3, 4), 0),
    "slice": lambda r: case(f32(r, 3, 4, 5), [0, 2], [1, 1], [3, 4]),
    "strided_slice": lambda r: case(f32(r, 3, 6), [0, 1], [0, 5], [3, 0],
                                    [2, -2]),
    "crop": lambda r: case(f32(r, 4, 5), [2, 3], [1, 1]),
    "pad": lambda r: case(f32(r, 1, 2, 3, 3), [1, 1, 2, 0], value=0.5),
    "shard_index": lambda r: case(_i([1], [6], [12], [19]), 20, 2, 0),
    "repeat_interleave": lambda r: case(f32(r, 3, 2), 2, axis=0),
    "moveaxis": lambda r: case(f32(r, 2, 3, 4), 0, 2),
    "as_complex": lambda r: case(f32(r, 3, 2)),
    "as_real": lambda r: case((f32(r, 3) + 1j * f32(r, 3))
                              .astype(np.complex64)),
    "tensordot": lambda r: case(f32(r, 3, 4), f32(r, 4, 5), 1),
    "tolist": lambda r: case(f32(r, 2, 3)),
    "cast": lambda r: case(f32(r, 2, 3) * 4, "int32"),
}

LOGIC = {
    "equal": lambda r: case(ints(r, 0, 3, 3, 4), ints(r, 0, 3, 3, 4)),
    "not_equal": lambda r: case(ints(r, 0, 3, 3, 4), 1),
    "greater_than": lambda r: case(f32(r, 3, 4), f32(r, 3, 4)),
    "greater_equal": lambda r: case(f32(r, 3, 4), 0.0),
    "less_than": lambda r: case(f32(r, 3, 4), f32(r, 4)),
    "less_equal": lambda r: case(ints(r, 0, 3, 3, 4), ints(r, 0, 3, 3, 4)),
    "equal_all": lambda r: case(ints(r, 0, 2, 3), ints(r, 0, 2, 3)),
    "allclose": lambda r: case(np.ones(3, np.float32),
                               np.ones(3, np.float32) + 1e-7),
    "isclose": lambda r: case(f32(r, 3, 4), f32(r, 3, 4) * 0 + 0.1),
    "logical_and": lambda r: case(f32(r, 3, 4) > 0, f32(r, 3, 4) > 0),
    "logical_or": lambda r: case(f32(r, 3, 4) > 0, f32(r, 3, 4) > 0),
    "logical_xor": lambda r: case(f32(r, 3, 4) > 0, f32(r, 3, 4) > 0),
    "logical_not": lambda r: case(f32(r, 3, 4) > 0),
    "bitwise_and": lambda r: case(ints(r, 0, 16, 3, 4), ints(r, 0, 16, 3, 4)),
    "bitwise_or": lambda r: case(ints(r, 0, 16, 3, 4), ints(r, 0, 16, 3, 4)),
    "bitwise_xor": lambda r: case(ints(r, 0, 16, 3, 4), ints(r, 0, 16, 3, 4)),
    "bitwise_not": lambda r: case(ints(r, 0, 16, 3, 4)),
    "is_empty": lambda r: case(np.zeros((0, 3), np.float32)),
    "is_tensor": lambda r: case(f32(r, 2)),
    "where": lambda r: case(f32(r, 3, 4) > 0, f32(r, 3, 4), f32(r, 3, 4)),
    "masked_select": lambda r: case(f32(r, 3, 4), f32(r, 3, 4) > 0),
    "nonzero": lambda r: case(ints(r, 0, 2, 3, 4), as_tuple=True),
}

SEARCH = {
    "argmax": lambda r: case(f32(r, 3, 4), axis=1),
    "argmin": lambda r: case(f32(r, 3, 4), axis=0, keepdim=True),
    "argsort": lambda r: case(f32(r, 3, 4), axis=1, descending=True),
    "sort": lambda r: case(f32(r, 3, 4), axis=0),
    "topk": lambda r: case(f32(r, 3, 5), 2, axis=1),
    "kthvalue": lambda r: case(f32(r, 3, 5), 2, axis=1),
    "mode": lambda r: case(np.array([[1, 3, 3, 2, 3, 1], [4, 4, 0, 0, 0, 5]],
                                    np.float32), axis=1),
    "index_sample": lambda r: case(f32(r, 3, 5), _i([0, 4], [1, 1], [3, 2])),
    "masked_select": lambda r: case(f32(r, 3, 4), f32(r, 3, 4) > 0),
    "where": lambda r: case(f32(r, 3, 4) > 0),
    "nonzero": lambda r: case(ints(r, 0, 2, 3, 4)),
    "searchsorted": lambda r: case(np.sort(f32(r, 6)), f32(r, 2, 3),
                                   right=True),
    "bucketize": lambda r: case(f32(r, 2, 3), np.sort(f32(r, 6))),
}


@pytest.mark.parametrize("name", jmanip.__all__)
def test_manipulation_matches_jax(name):
    run_case(name, getattr(jmanip, name), getattr(pmanip, name),
             MANIPULATION[name](rng()))


@pytest.mark.parametrize("name", jlogic.__all__)
def test_logic_matches_jax(name):
    run_case(name, getattr(jlogic, name), getattr(plogic, name),
             LOGIC[name](rng()))


@pytest.mark.parametrize("name", jsearch.__all__)
def test_search_matches_jax(name):
    run_case(name, getattr(jsearch, name), getattr(psearch, name),
             SEARCH[name](rng()))


def test_paddle_meanings_on_the_facade():
    """The methods that share torch's names keep Paddle's meanings."""
    x = pp.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    assert [p.shape for p in x.split(2, axis=2)] == [[2, 3, 2]] * 2
    assert x.transpose([2, 0, 1]).shape == [4, 2, 3]
    idx = pp.to_tensor(np.array([0, 2]))
    assert x.index_select(idx, axis=1).shape == [2, 2, 4]
    assert x.max(axis=1).shape == [2, 4] and x.size == 24
    assert isinstance(x.shape, list)
    assert x.sort(axis=0).shape == [2, 3, 4]
