"""``nn.Layer`` and its containers: counterpart of
``paddle_tpu/nn/layer.py``.

``Layer`` is a ``torch.nn.Module`` with Paddle's names on top
(``create_parameter``, ``add_sublayer``, ``add_parameter``,
``register_buffer(persistable=)``, ``sublayers``, ``named_sublayers``,
``set_state_dict``, ``clear_gradients``, ``full_name``, ``astype``,
``register_forward_post_hook``); every layer class of the port derives
from it. ``parameters()`` returns a list, as Paddle's does; given
torch's ``recurse=`` keyword it is torch's generator, so torch's own
recursion is untouched. Every parameter it registers or yields is a
``core.tensor.Parameter`` (its class swapped in place, so a tied weight
stays one object; a torch module inside a model, such as GPT's
``torch.nn.Embedding``, has its parameters swapped when they are
listed).

The facade boundary (``core/tensor.py``): a layer whose ``forward`` is
the port's own runs on torch tensors; called with facade tensors it
unwraps them and wraps what it returns. A layer whose ``forward`` a user
wrote (outside the port) is Paddle code: it gets facades (torch inputs
are wrapped) and returns what it computes, unwrapped again for a caller
that passed torch tensors, such as ``TrainStep``. Hooks run inside the
call and see what ``forward`` sees.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.random import random_generator
from ..core.tensor import (Parameter, as_parameter, has_facade, to_torch,
                           unwrap, wrap)

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict"]

_PORT = __name__.split(".")[0] + "."
_call = nn.Module.__call__


class Layer(nn.Module):
    #: True where ``forward`` is user code (set per class)
    _facade_forward = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fwd = cls.__dict__.get("forward")
        if fwd is not None:
            cls._facade_forward = not getattr(
                fwd, "__module__", "").startswith(_PORT)

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._full_name = name_scope or type(self).__name__.lower()
        self._dtype = dtypes.convert_dtype(dtype)

    def __call__(self, *args, **kwargs):
        if type(self)._facade_forward:
            facade_in = has_facade(args) or has_facade(kwargs)
            out = _call(self, *wrap(args), **wrap(kwargs))
            return out if facade_in else unwrap(out)
        if has_facade(args) or (kwargs and has_facade(kwargs)):
            return wrap(_call(self, *unwrap(args), **unwrap(kwargs)))
        return _call(self, *args, **kwargs)

    # -- registration -------------------------------------------------------
    def register_parameter(self, name: str, param) -> None:
        super().register_parameter(
            name, None if param is None else as_parameter(param))

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new ``Parameter`` on the default device, drawn from the
        random functions' generator (``paddle.seed``) by ``attr``'s
        initializer, else ``default_initializer``, else zeros for a bias
        and XavierUniform otherwise; ``attr=False`` gives None."""
        from .initializer import (Constant, ParamAttr, XavierUniform,
                                  _resolve_attr)
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias \
                else XavierUniform()
        resolved = _resolve_attr(attr, default_initializer)
        if resolved is None:
            return None
        init, trainable, name = resolved
        dev = resolve_device(None)
        d = dtypes.convert_dtype(dtype) or self._dtype or torch.float32
        data = init(tuple(int(s) for s in shape), d, dev,
                    random_generator(dev))
        p = Parameter(data, requires_grad=trainable, name=name)
        p.optimize_attr = {"learning_rate": attr.learning_rate
                           if isinstance(attr, ParamAttr) else 1.0}
        p.regularizer = attr.regularizer if isinstance(attr, ParamAttr) \
            else None
        return p

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent=None):
        """Paddle's ``persistable=`` or torch's ``persistent=``."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(
            name, None if tensor is None else to_torch(tensor),
            persistent=bool(keep))
        return tensor

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        """The parameters as a list; with torch's ``recurse=`` keyword,
        torch's generator."""
        if recurse is not None:
            return super().parameters(recurse)
        return list(super().parameters(bool(include_sublayers)))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        """torch's generator, each parameter a ``Parameter`` (one that a
        torch module inside the model registered is made one here)."""
        rec = include_sublayers if recurse is None else recurse
        for name, p in super().named_parameters(prefix, bool(rec),
                                                remove_duplicate):
            yield name, as_parameter(p)

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            if layers_set is not None:
                if id(m) in layers_set:
                    continue
                layers_set.add(id(m))
            yield name, m

    def sublayers(self, include_self=False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(
            include_self=include_self)]

    # -- state --------------------------------------------------------------
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load numpy arrays, facades or torch tensors into the existing
        parameters and buffers by name (shape-checked, cast to their
        dtype and device). Returns ``(missing, unexpected)``."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            target = own[name]
            src = value if isinstance(value, torch.Tensor) else to_torch(
                value, place=target.device)
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: got {tuple(src.shape)}, "
                    f"expected {tuple(target.shape)}")
            target.copy_(src.to(target.device, target.dtype))
        missing = [n for n in own if n not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    # -- misc ---------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each call (torch's
        forward hook); a returned value replaces the outputs."""
        return self.register_forward_hook(hook)

    def full_name(self) -> str:
        return getattr(self, "_full_name", type(self).__name__.lower())

    def astype(self, dtype):
        return self.to(dtype=dtypes.convert_dtype(dtype))


class Sequential(nn.Sequential, Layer):
    """Children ``"0"``, ``"1"``, ... in order, or by the names an
    ``OrderedDict`` or ``(name, layer)`` pairs give, so state-dict keys
    are the JAX model's (``features.0.weight``)."""

    def __init__(self, *layers):
        import collections
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__(collections.OrderedDict(
            layer if isinstance(layer, tuple) else (str(i), layer)
            for i, layer in enumerate(layers)))


class LayerList(nn.ModuleList, Layer):
    pass


class ParameterList(nn.ParameterList, Layer):
    pass


class LayerDict(nn.ModuleDict, Layer):
    pass
