"""``jit.save`` / ``jit.load``: a model bundle that either package reads.

Counterpart of ``paddle_tpu/jit/to_static.py:1428-1552``. A bundle is a
path prefix and two files, in the JAX package's formats:

- ``<path>.pdiparams``: a pickle of numpy arrays by state-dict name
  (bf16 written as its float32 widening, :mod:`..framework.io`);
- ``<path>.pdmodel.meta``: a pickled dict with the JAX keys ``class``,
  ``input_spec``, ``param_names`` and ``buffer_names``, and one key of
  the port's own, ``torch_recipe``: the model's module and class inside
  ``paddle_tpu_torch.models``, its config dataclass as a dict, which
  ``Linear``s are ``slim.QuantizedLinear`` (with the static activation
  scale PTQ set, or None), and the dtype of each tensor, so that bf16
  comes back bit for bit.

The port writes no executable: no ``.jaxexport`` and no ``.mlir``. The
JAX package's bundle is a compiled XLA program; the port's kernels are
``ctypes`` calls into libraries built at run time, which
``torch.export`` cannot trace unless each one is registered as a
``torch.library`` operator. So the port's bundle is a recipe:
:func:`load` rebuilds ``class(config)`` on the requested device, swaps
in ``QuantizedLinear`` shells where the recipe says so and loads the
arrays strictly (the rules of ``models.convert.load_jax_weights``). A
class outside ``paddle_tpu_torch.models`` is refused, never imported.

Across the two packages the weights move both ways: a JAX bundle has no
``torch_recipe``, so :func:`load` returns its arrays dict, and the JAX
``jit.load`` of a port bundle finds no ``.jaxexport`` and returns the
arrays dict too.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..framework.io import load as _load_arrays
from ..framework.io import to_numpy

__all__ = ["save", "load", "TranslatedLayer"]

_MODELS = "paddle_tpu_torch.models"
_MODEL_MODULE = re.compile(r"paddle_tpu_torch\.models\.[a-z_]+")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _spec(s):
    """``(shape, dtype)`` of an input spec: an object with ``.shape``
    (and ``.dtype``, float32 when it has none) or a shape."""
    shape = getattr(s, "shape", s)
    return (tuple(shape), _dtype_name(getattr(s, "dtype", "float32")))


def _recipe(layer: nn.Module, state: Dict[str, torch.Tensor]):
    from ..slim import QuantizedLinear
    cls, cfg = type(layer), getattr(layer, "cfg", None)
    if not _MODEL_MODULE.fullmatch(cls.__module__) \
            or not dataclasses.is_dataclass(cfg):
        raise ValueError(
            f"jit.save with input_spec rebuilds the model from a recipe: "
            f"{cls.__module__}.{cls.__name__} is not a model of "
            f"{_MODELS} with a dataclass .cfg (save without input_spec "
            "for the weights alone)")
    return {
        "module": cls.__module__,
        "class": cls.__name__,
        "config_class": type(cfg).__name__,
        "config": dataclasses.asdict(cfg),
        "quantized": {name: m.act_scale for name, m in layer.named_modules()
                      if isinstance(m, QuantizedLinear)},
        "dtypes": {k: _dtype_name(v.dtype) for k, v in state.items()},
    }


def save(layer: nn.Module, path: str, input_spec=None,
         state: Optional[Dict[str, torch.Tensor]] = None, **configs):
    """Write ``layer``'s bundle at the prefix ``path``. With
    ``input_spec`` the meta carries the recipe that :func:`load`
    rebuilds the model from; without, the bundle holds the weights
    alone. ``state`` replaces the layer's own tensors by name (a
    predictor's bf16 copy); the default is ``layer.state_dict()``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = layer.state_dict()
    state = {k: (state or {}).get(k, v) for k, v in sd.items()}
    param_names = [k for k, _ in layer.named_parameters() if k in sd]
    meta: Dict[str, Any] = {"class": type(layer).__name__}
    if input_spec:
        meta["input_spec"] = [_spec(s) for s in input_spec]
        meta["torch_recipe"] = _recipe(layer, state)
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({k: to_numpy(v) for k, v in state.items()}, f,
                    protocol=4)
    with open(path + ".pdmodel.meta", "wb") as f:
        pickle.dump({**meta, "param_names": param_names,
                     "buffer_names": [k for k in sd
                                      if k not in set(param_names)]}, f,
                    protocol=4)


class TranslatedLayer:
    """The model rebuilt from a bundle, called like the saved layer:
    positional tensors or arrays, or the named feeds ``x0``, ``x1``, ...
    A bundle whose floating parameters are bf16 computes in bf16: its
    floating inputs are cast to bf16 and its floating outputs come back
    float32, as ``inference.Predictor`` does under ``enable_tpu_bf16``.
    Returns a tensor, or a list of them."""

    def __init__(self, layer: nn.Module, meta: Dict[str, Any]):
        self.layer = layer
        self._meta = meta
        self.bf16 = any(p.dtype == torch.bfloat16
                        for p in layer.parameters())

    def __call__(self, *inputs, **feeds):
        if feeds and inputs:
            raise TypeError("pass inputs positionally OR as named feeds, "
                            "not both")
        if feeds:
            n_in = len(self._meta.get("input_spec") or []) or len(feeds)

            def idx(n):
                if not (n.startswith("x") and n[1:].isdigit()):
                    raise KeyError(
                        f"unknown feed {n!r}: a jit.save export names its "
                        f"inputs positionally as "
                        f"{['x%d' % i for i in range(n_in)]}")
                return int(n[1:])
            inputs = [feeds[k] for k in sorted(feeds, key=idx)]
        outs = run_layer(self.layer, None, inputs, self.bf16)
        return outs[0] if len(outs) == 1 else outs


def run_layer(layer: nn.Module, state, inputs, bf16: bool):
    """``layer`` on ``inputs`` (tensors or arrays, moved to the layer's
    device) under ``torch.inference_mode()``, through
    ``torch.func.functional_call`` on ``state`` when given. Under
    ``bf16`` floating inputs are cast to bf16 and floating outputs back
    to float32. Returns the list of outputs."""
    device = next(iter(layer.parameters())).device
    args = []
    for a in inputs:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        t = t.to(device)
        if bf16 and t.is_floating_point():
            t = t.to(torch.bfloat16)
        args.append(t)
    with torch.inference_mode():
        out = layer(*args) if state is None else \
            torch.func.functional_call(layer, state, tuple(args))
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o.float() if bf16 and o.is_floating_point() else o
            for o in outs]


def _rebuild(recipe: Dict[str, Any], device: torch.device) -> nn.Module:
    from ..slim import QuantizedLinear
    mod_name = recipe["module"]
    if not _MODEL_MODULE.fullmatch(mod_name):
        raise ValueError(f"jit.load rebuilds models of {_MODELS} only, "
                         f"not {mod_name}.{recipe['class']}")
    module = importlib.import_module(mod_name)
    cfg = getattr(module, recipe["config_class"])(**recipe["config"])
    model = getattr(module, recipe["class"])(cfg, device=device)
    for name, act_scale in recipe["quantized"].items():
        owner_name, _, child = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        lin = getattr(owner, child)
        K, N = lin.weight.shape
        setattr(owner, child, QuantizedLinear(
            np.zeros((K, N), np.int8), np.ones((N,), np.float32),
            lin.bias, act_scale=act_scale, device=device))
    for name, dt in recipe["dtypes"].items():
        dtype = getattr(torch, dt)
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        t = getattr(owner, leaf)
        if t.dtype != dtype:
            if isinstance(t, nn.Parameter):
                t.data = t.data.to(dtype)
            else:
                setattr(owner, leaf, t.to(dtype))
    return model.eval()


def load(path: str, device: DeviceLike = None, **configs):
    """Restore a :func:`save` bundle on ``device`` (the card unless
    ``device="cpu"`` is passed) as a :class:`TranslatedLayer`; a bundle
    without a recipe (a weights-only save, or any bundle the JAX package
    wrote) returns its arrays dict."""
    from ..models.convert import load_jax_weights
    arrays = _load_arrays(path + ".pdiparams")
    with open(path + ".pdmodel.meta", "rb") as f:
        meta = pickle.load(f)
    recipe = meta.get("torch_recipe")
    if recipe is None:
        return arrays
    model = _rebuild(recipe, resolve_device(device))
    with torch.no_grad():
        load_jax_weights(model, arrays)
    return TranslatedLayer(model, meta)
