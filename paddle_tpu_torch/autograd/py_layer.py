"""PyLayer: a custom forward and backward, counterpart of
``paddle_tpu/autograd/py_layer.py``, over ``torch.autograd.Function``.

The user's ``forward(ctx, *args)`` and ``backward(ctx, *grads)`` are
Paddle code: they get and return facade tensors. ``backward`` returns
one gradient per tensor argument of ``forward``, in order (``None`` for
one that takes none). ``ctx.saved_tensor`` is the saved tuple and
calling it returns the same, so both the JAX facade's property and
Paddle's ``saved_tensor()`` read it.
"""

from __future__ import annotations

import torch

from ..core.tensor import Tensor, unwrap, wrap

__all__ = ["PyLayer", "PyLayerContext"]


class _Saved(tuple):
    def __call__(self):
        return self


class PyLayerContext:
    def __init__(self):
        self._saved = _Saved()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = _Saved(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Function(torch.autograd.Function):
    """One PyLayer call: ``args`` are the layer's arguments with every
    tensor among them passed positionally after them, so that autograd
    sees the tensors."""

    @staticmethod
    def forward(fctx, layer, pctx, spec, kwargs, *tensors):
        it = iter(tensors)
        args = [Tensor._wrap(next(it)) if is_t else a for is_t, a in spec]
        out = layer.forward(pctx, *args, **kwargs)
        fctx.layer, fctx.pctx, fctx.n_in = layer, pctx, len(tensors)
        fctx.multi = isinstance(out, (tuple, list))
        outs = tuple(out) if fctx.multi else (out,)
        return tuple(o._data if type(o) is Tensor else o for o in outs) \
            if fctx.multi else unwrap(outs[0])

    @staticmethod
    def backward(fctx, *grads):
        grads = fctx.layer.backward(fctx.pctx, *[
            None if g is None else Tensor._wrap(g) for g in grads])
        grads = grads if isinstance(grads, (tuple, list)) else (grads,)
        grads = [unwrap(g) for g in grads][:fctx.n_in]
        grads += [None] * (fctx.n_in - len(grads))
        return (None, None, None, None) + tuple(grads)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grad_outputs):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        spec, tensors = [], []
        for a in args:
            t = a._data if type(a) is Tensor else a
            is_t = isinstance(t, torch.Tensor)
            spec.append((is_t, None if is_t else a))
            if is_t:
                tensors.append(t)
        out = _Function.apply(cls, ctx, spec, kwargs, *tensors)
        return wrap(out)
