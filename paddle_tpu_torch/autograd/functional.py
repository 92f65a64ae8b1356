"""``paddle.grad`` and the functional transforms: counterpart of
``paddle_tpu/autograd/functional.py``.

:func:`grad` is ``torch.autograd.grad`` (the JAX partial backward):
it leaves every ``.grad`` alone, gives zeros for an input the outputs do
not reach unless ``allow_unused`` (the JAX package's rule), and stops
the gradient at ``no_grad_vars`` (a hook zeroes what flows into them
during the call). ``vjp``, ``jvp``, ``jacobian`` and ``hessian`` run
the function again on fresh leaves through ``torch.autograd.functional``
(the JAX package re-traces it under ``jax.vjp`` / ``jacrev`` /
``hessian``); the function is Paddle code and gets facades.
"""

from __future__ import annotations

import torch

from ..core.tensor import Tensor, to_torch, unwrap, wrap

__all__ = ["grad", "vjp", "jvp", "jacobian", "hessian"]


def _list(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    outs = [to_torch(o) for o in _list(outputs)]
    ins = [to_torch(i) for i in _list(inputs)]
    gos = None if grad_outputs is None else [
        None if g is None else to_torch(g) for g in _list(grad_outputs)]
    hooks = [to_torch(v).register_hook(torch.zeros_like)
             for v in _list(no_grad_vars or [])
             if to_torch(v).requires_grad]
    try:
        grads = torch.autograd.grad(outs, ins, gos,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=True)
    finally:
        for h in hooks:
            h.remove()
    return [wrap(g) if g is not None else (
        None if allow_unused else Tensor._wrap(torch.zeros_like(i)))
        for g, i in zip(grads, ins)]


def _pure(func):
    """``func`` over facades as a function of torch tensors."""
    def fn(*ts):
        return unwrap(func(*[Tensor._wrap(t) for t in ts]))
    return fn


def _primals(xs):
    return tuple(to_torch(x).detach() for x in _list(xs))


def _shape_like(xs, out):
    """``out`` (a tuple, one entry per input) as a single value for a
    single input, as the JAX transforms return it."""
    return out[0] if not isinstance(xs, (list, tuple)) else out


def vjp(func, xs, v=None):
    """``(outputs, vjp)``; ``v`` defaults to ones."""
    raw = _primals(xs)
    vv = None if v is None else tuple(to_torch(t) for t in _list(v))
    if vv is not None and len(vv) == 1:
        vv = vv[0]
    out, g = torch.autograd.functional.vjp(_pure(func), raw, vv)
    return wrap(out), _shape_like(xs, wrap(list(g)))


def jvp(func, xs, v=None):
    """``(outputs, jvp)``, forward mode; ``v`` defaults to ones."""
    raw = _primals(xs)
    vv = None if v is None else tuple(to_torch(t) for t in _list(v))
    if vv is None:
        vv = tuple(torch.ones_like(r) for r in raw)
    out, t = torch.autograd.functional.jvp(_pure(func), raw, vv)
    return wrap(out), wrap(t)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """One input: ``[*out_shape, *in_shape]``; several: a tuple, one
    Jacobian per input."""
    raw = _primals(xs)
    jac = torch.autograd.functional.jacobian(_pure(func), raw,
                                             create_graph=create_graph)
    return _shape_like(xs, wrap(jac))


def hessian(func, xs, create_graph=False, allow_unused=False):
    """Hessian of a scalar-output function: one input, a tensor; several,
    a tuple of tuples."""
    raw = _primals(xs)

    def scalar(*ts):
        out = _pure(func)(*ts)
        out = out[0] if isinstance(out, tuple) else out
        if out.dim() != 0:
            raise ValueError("hessian needs a scalar-output function, got "
                             f"output shape {tuple(out.shape)}")
        return out

    h = torch.autograd.functional.hessian(scalar, raw,
                                          create_graph=create_graph)
    if not isinstance(xs, (list, tuple)):
        return wrap(h[0][0])
    return wrap(h)
