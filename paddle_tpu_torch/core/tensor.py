"""The eager tensor facade: counterpart of ``paddle_tpu/core/tensor.py``.

Where Paddle semantics stop
---------------------------
Paddle's tensor methods share names with torch's but not their meaning:
``split(2)`` cuts two sections where torch cuts sections of size 2,
``transpose(perm)`` is torch's ``permute``, ``index_select(index,
axis)`` takes its arguments the other way round, ``sort`` returns the
values alone, ``max(axis)`` one tensor, ``size`` is a property and
``shape`` a list. A ``torch.Tensor`` that carried Paddle's methods would
compute something else, silently, the moment it reached torch's Python
code or the port's own modules (torch itself does ``x.shape[:-1] +
(n,)``). So the facade is no ``torch.Tensor``:

- :class:`Tensor` is a wrapper over one ``torch.Tensor`` (``_data``), as
  the JAX facade wraps a ``jax.Array``. It has Paddle's methods only.
  Handed to torch or to a port module that expects a tensor, it raises
  a ``TypeError`` instead of computing the wrong thing.
- Inside the port's modules and inside torch every tensor is a plain
  ``torch.Tensor`` and every parameter a ``torch.nn.Parameter``. The
  facade exists only at the surface user code sees: what the
  ``paddle.*`` functions and Tensor methods return, ``to_tensor``, and
  what a ``nn.Layer`` returns when it was called with facade tensors.
  :func:`paddle_api` is that boundary for a function (facade in, plain
  tensors through, facade out; plain in, plain out) and
  ``nn.Layer.__call__`` for a layer.
- :class:`Parameter` is a ``torch.nn.Parameter`` subclass that only adds
  the Paddle attributes torch lacks (``stop_gradient``, ``trainable``,
  ``name``, ``gradient()``, ``clear_grad()``, ``set_value``, a
  ``numpy()`` that also works on the card and under grad) and overrides
  no torch method, so the port and torch use it as any parameter.
  ``isinstance(p, paddle.Tensor)`` holds for it, as in the JAX package.

There is no tape: torch's autograd is the tape. ``stop_gradient`` is
``not requires_grad``; :meth:`Tensor.backward` is
``torch.autograd.backward`` and accumulates into the leaves' ``.grad``.
The JAX package's ``apply`` / ``TapeNode`` machinery and its eager jit
cache are not ported. A facade op costs a torch call plus one wrapper
object (``chip_smoke.py`` phase 27 (b) prints the microseconds).

In-place methods (``add_``, ``__setitem__``, ...) rebind the facade to
a new tensor, as the JAX facade's ``_adopt`` does: a leaf that requires
grad may be updated (torch would refuse), and a slice taken before the
update keeps its values.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from . import dtype as dtypes
from .device import Place, _parse, resolve_device

__all__ = ["Tensor", "Parameter", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "backward", "to_torch",
           "wrap", "unwrap", "has_facade", "paddle_api"]


# -- grad mode -------------------------------------------------------------
def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> None:
    torch._C._set_grad_enabled(bool(mode))


def no_grad(fn=None):
    """``with paddle.no_grad():``, ``@paddle.no_grad()`` or
    ``@paddle.no_grad``."""
    return torch.no_grad()(fn) if fn is not None else torch.no_grad()


def enable_grad(fn=None):
    return torch.enable_grad()(fn) if fn is not None else \
        torch.enable_grad()


# -- conversion ------------------------------------------------------------
def to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """``data`` (a facade, a torch tensor, a numpy array, a list or a
    scalar) as a torch tensor: numpy float64 becomes float32 unless
    ``dtype`` says otherwise (the JAX facade's rule); new tensors go to
    ``place``, else the default device (:func:`core.device.set_device`,
    else the card)."""
    if type(data) is Tensor:
        data = data._data
    dtype = dtypes.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        if place is not None:
            t = t.to(resolve_device(_parse(place)))
        return t
    if isinstance(data, (list, tuple)) and any(
            isinstance(d, (Tensor, torch.Tensor)) for d in data):
        data = [np.asarray(to_torch(d).detach().cpu()) for d in data]
    arr = np.asarray(data)
    if dtype is None and arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == object:
        raise TypeError(f"cannot make a tensor of {type(data).__name__}")
    dev = resolve_device(None if place is None else _parse(place))
    # a copy: the tensor never aliases the caller's array
    return torch.tensor(arr, dtype=dtype, device=dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class _TensorMeta(type):
    def __instancecheck__(cls, obj):
        # a port Parameter is a torch.nn.Parameter; it counts as a
        # paddle.Tensor as the JAX Parameter does
        return type.__instancecheck__(cls, obj) or (
            cls is Tensor and isinstance(obj, Parameter))


_new = object.__new__


class Tensor(metaclass=_TensorMeta):
    """Eager tensor over a ``torch.Tensor`` (``_data``).

    ``stop_gradient`` defaults to True (``requires_grad`` False), as in
    Paddle; ``Parameter`` flips it."""

    __slots__ = ("_data", "name", "persistable", "__weakref__")
    # numpy defers its binary operators to the facade's reflected ones
    __array_ufunc__ = None

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None):
        t = to_torch(data, dtype, place)
        if t.requires_grad or not stop_gradient:
            # a leaf of its own: the caller's tensor keeps its flags
            t = t.detach()
            if not stop_gradient:
                t.requires_grad_(True)
        self._data = t
        self.name = name
        self.persistable = False

    @classmethod
    def _wrap(cls, t: torch.Tensor) -> "Tensor":
        o = _new(cls)
        o._data = t
        o.name = None
        o.persistable = False
        return o

    # -- properties ---------------------------------------------------------
    @property
    def data(self):
        return self

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    def dim(self) -> int:
        return self._data.dim()

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def place(self) -> Place:
        return _parse(self._data.device)

    @property
    def is_leaf(self) -> bool:
        return self._data.is_leaf

    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        t = self._data
        if bool(value) == (not t.requires_grad):
            return
        if t.is_leaf:
            t.requires_grad_(not value)
        else:
            self._data = t.detach()

    @property
    def grad(self) -> Optional["Tensor"]:
        t = self._data
        if not t.is_leaf and not t.retains_grad:
            return None
        g = t.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value) -> None:
        self._data.grad = None if value is None else to_torch(value)

    def numel(self) -> int:
        return self._data.numel()

    def numpy(self) -> np.ndarray:
        return _numpy(self._data)

    def __array__(self, dtype=None, copy=None):
        arr = _numpy(self._data)
        return arr if dtype is None else arr.astype(dtype)

    def item(self):
        return self._data.detach().item()

    def tolist(self):
        return self._data.detach().tolist()

    def gradient(self) -> Optional[np.ndarray]:
        g = self.grad
        return None if g is None else g.numpy()

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __iter__(self):
        if self._data.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        return (self[i] for i in range(self._data.shape[0]))

    def __repr__(self):
        grad_part = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtypes.dtype_to_str(self.dtype)}, "
                f"place={self.place}{grad_part},\n       "
                f"{self.numpy()!r})")

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __index__(self):
        return int(self._data.detach())

    def __format__(self, spec):
        if self._data.dim() == 0:
            return format(self.item(), spec)
        return format(str(self), spec)

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        t = self._data.detach().clone()
        if self._data.requires_grad:
            t.requires_grad_(True)
        new = Tensor._wrap(t)
        new.name = self.name
        new.persistable = self.persistable
        memo[id(self)] = new
        return new

    # -- conversions --------------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        return Tensor._wrap(self._data.to(dtypes.convert_dtype(dtype)))

    cast = astype

    def clone(self) -> "Tensor":
        return Tensor._wrap(self._data.clone())

    def detach(self) -> "Tensor":
        t = Tensor._wrap(self._data.detach())
        t.name = self.name
        return t

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self._data.cpu())

    def cuda(self, device_id=None, blocking=True) -> "Tensor":
        return Tensor._wrap(self._data.to(resolve_device(
            "cuda" if device_id is None else f"cuda:{device_id}")))

    def to(self, device=None, dtype=None, blocking=None) -> "Tensor":
        t = self._data
        if dtype is not None:
            t = t.to(dtypes.convert_dtype(dtype))
        if device is not None:
            t = t.to(resolve_device(_parse(device)))
        return Tensor._wrap(t)

    def pin_memory(self) -> "Tensor":
        return Tensor._wrap(self._data.pin_memory())

    def contiguous(self) -> "Tensor":
        return Tensor._wrap(self._data.contiguous())

    def value(self) -> "Tensor":
        return self

    def set_value(self, value) -> None:
        """Take ``value``'s values (cast to this dtype and device) as a
        new leaf, rebinding as an in-place method does."""
        t = self._data
        v = to_torch(value).detach().to(t.device, t.dtype).reshape(
            t.shape).clone()
        self._rebind(v.requires_grad_(t.requires_grad))

    # -- autograd -----------------------------------------------------------
    def retain_grads(self) -> "Tensor":
        if self._data.requires_grad and not self._data.is_leaf:
            self._data.retain_grad()
        return self

    def register_hook(self, hook: Callable):
        """``hook(grad)`` (a facade) on this tensor's gradient; a returned
        tensor replaces it. Returns a handle with ``remove()``."""
        def torch_hook(g):
            res = hook(Tensor._wrap(g))
            return None if res is None else to_torch(res)
        return self._data.register_hook(torch_hook)

    def clear_grad(self) -> None:
        self._data.grad = None

    clear_gradient = clear_grad

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        backward(self, grad_tensor, retain_graph)

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx) -> "Tensor":
        return Tensor._wrap(self._data[_index(idx)])

    def __setitem__(self, idx, value) -> None:
        new = self._data.clone()
        new[_index(idx)] = value._data if type(value) is Tensor else (
            to_torch(value, place=_parse(new.device))
            if isinstance(value, (np.ndarray, list)) else value)
        self._rebind(new)

    def _rebind(self, t: torch.Tensor) -> None:
        """The in-place update: this facade now holds ``t`` (the JAX
        facade's ``_adopt``)."""
        self._data = t

    # the Paddle method surface and the operators are attached by
    # paddle_tpu_torch.tensor at import time


def _index(idx):
    t = type(idx)
    if t is Tensor:
        return idx._data
    if t is tuple:
        return tuple(i._data if type(i) is Tensor else i for i in idx)
    if t is list and any(type(i) is Tensor for i in idx):
        return [i._data if type(i) is Tensor else i for i in idx]
    return idx


def backward(tensor, grad_tensor=None, retain_graph: bool = False) -> None:
    """Reverse-mode autograd from ``tensor``: gradients accumulate into
    the leaves' ``.grad``; a tensor that does not require grad is left
    alone, as in the JAX facade."""
    t = to_torch(tensor)
    if not t.requires_grad:
        return
    g = None if grad_tensor is None else to_torch(grad_tensor)
    torch.autograd.backward(t, g, retain_graph=bool(retain_graph))


# -- Parameter -------------------------------------------------------------
class Parameter(torch.nn.Parameter):
    """A ``torch.nn.Parameter`` with Paddle's attributes.

    It overrides no torch method but ``numpy()`` (which here also works
    on the card and while the parameter requires grad), so torch and the
    port's modules treat it as any parameter. ``Parameter(data,
    requires_grad)`` is torch's constructor (``copy.deepcopy`` calls it
    so); ``dtype``, ``name`` and ``trainable`` are Paddle's keywords."""

    def __new__(cls, data=None, requires_grad=True, *, dtype=None,
                name=None, trainable=None):
        t = torch.empty(0) if data is None else to_torch(data, dtype)
        if trainable is not None:
            requires_grad = bool(trainable)
        p = torch.Tensor._make_subclass(cls, t.detach(), requires_grad)
        if name is not None:
            p.name = name
        return p

    def __init__(self, *args, **kwargs):
        pass

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not value)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    @property
    def name(self):
        return self.__dict__.get("_paddle_name")

    @name.setter
    def name(self, value) -> None:
        self.__dict__["_paddle_name"] = value

    @property
    def persistable(self) -> bool:
        return self.__dict__.get("_persistable", True)

    @persistable.setter
    def persistable(self, value: bool) -> None:
        self.__dict__["_persistable"] = bool(value)

    @property
    def place(self) -> Place:
        return _parse(self.device)

    def numpy(self, *, force: bool = False) -> np.ndarray:
        return _numpy(self)

    def gradient(self) -> Optional[np.ndarray]:
        return None if self.grad is None else _numpy(self.grad)

    def clear_grad(self) -> None:
        self.grad = None

    clear_gradient = clear_grad

    def set_value(self, value) -> None:
        with torch.no_grad():
            self.copy_(to_torch(value).reshape(self.shape))

    def astype(self, dtype) -> Tensor:
        return Tensor._wrap(self.to(dtypes.convert_dtype(dtype)))


def as_parameter(p: torch.nn.Parameter) -> Parameter:
    """``p`` itself, made a :class:`Parameter` (its class is swapped, so
    every reference to it, a tied weight's too, stays the same
    object)."""
    if type(p) is torch.nn.Parameter:
        p.__class__ = Parameter
    return p


# -- the boundary ----------------------------------------------------------
def has_facade(obj) -> bool:
    t = type(obj)
    if t is Tensor:
        return True
    if t is tuple or t is list:
        for o in obj:
            if has_facade(o):
                return True
        return False
    if t is dict:
        for o in obj.values():
            if has_facade(o):
                return True
    return False


def unwrap(obj):
    """Facades in ``obj`` (recursing into tuples, lists, dicts) as their
    torch tensors."""
    t = type(obj)
    if t is Tensor:
        return obj._data
    if t is tuple or t is list:
        return t(unwrap(o) for o in obj)
    if t is dict:
        return {k: unwrap(v) for k, v in obj.items()}
    return obj


def wrap(obj):
    """Torch tensors in ``obj`` (recursing into tuples, named tuples,
    lists, dicts) as facades."""
    if isinstance(obj, torch.Tensor):
        return Tensor._wrap(obj)
    t = type(obj)
    if t is tuple or t is list:
        return t(wrap(o) for o in obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return t(*(wrap(o) for o in obj))
    if t is dict:
        return {k: wrap(v) for k, v in obj.items()}
    return obj


def paddle_api(fn):
    """``fn`` (a port function over torch tensors) as a Paddle API
    function: called with any facade among its arguments, it runs on
    their torch tensors and returns facades; called with plain tensors,
    it is ``fn``."""
    @functools.wraps(fn)
    def api(*args, **kwargs):
        if has_facade(args) or (kwargs and has_facade(kwargs)):
            return wrap(fn(*unwrap(args), **unwrap(kwargs)))
        return fn(*args, **kwargs)
    api.plain = fn
    return api
