"""paddle.inference: ``Config`` + ``create_predictor`` for a live layer.

Counterpart of ``paddle_tpu/inference/__init__.py``: the deployment
surface (``Config``, ``create_predictor``, the zero-copy handles
``get_input_handle`` / ``copy_from_cpu`` / ``run`` / ``get_output_handle``
/ ``copy_to_cpu``, and ``run([arrays])``) over a predictor built from a
live layer. Building it applies the requested passes: ``layer.eval()``;
with ``enable_int8()`` ``slim.quantize_weights``, so every eligible
``Linear`` becomes a ``slim.QuantizedLinear`` whose product runs on the
int8 kernel; with ``enable_tpu_bf16()`` the floating parameters are cast
to bfloat16 in the predictor's own dict (the layer keeps float32). The
predictor keeps a detached copy of the layer's parameters and buffers,
taken when it is built, as the JAX predictor does. A run calls the
layer with ``torch.func.functional_call`` on that copy under
``torch.inference_mode()``, casts floating inputs to
bfloat16 under bf16, and returns float32 numpy arrays. The inputs go to
the layer's device: the card unless the layer was built with
``device="cpu"``.

Not ported yet (ROADMAP Queue 1): ``Config(model_path)`` and
``save_optimized_model`` wait for ``jit.save``/``io``; bf16 in
``create_serving_engine`` waits for a serving engine that keeps other
dtypes than float32. ``switch_ir_optim``'s conv+BatchNorm fold
(``inference/passes.py``) waits for the port's convolution and
BatchNorm layers: the port has neither, so no model of it has anything
to fold.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

__all__ = ["Config", "Predictor", "create_predictor",
           "create_serving_engine", "PrecisionType"]


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "float16"
    Int8 = "int8"


class Config:
    """Predictor configuration; build it from a live layer with
    ``Config.from_layer(layer, input_spec=[...])``."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        if model_path is not None:
            raise NotImplementedError(
                "Config(model_path): loading a saved model waits for the "
                "port of jit.save and io (ROADMAP Queue 1); use "
                "Config.from_layer")
        self.layer = None
        self.input_spec = None
        self._precision = PrecisionType.Float32
        self._weight_quant = False

    @classmethod
    def from_layer(cls, layer, input_spec) -> "Config":
        cfg = cls()
        cfg.layer = layer
        cfg.input_spec = list(input_spec)
        return cfg

    # -- optimization switches ---------------------------------------------
    def enable_tpu_bf16(self):
        """Compute in bfloat16 (the name is the JAX package's public
        surface; here it means bf16 on the card): floating parameters and
        inputs are cast to bf16, outputs come back float32."""
        self._precision = PrecisionType.Bfloat16

    def enable_int8(self):
        """Per-channel int8 weights that stay int8 through the product:
        each eligible Linear becomes a ``slim.QuantizedLinear``, whose
        forward quantizes its input per tensor and runs the int8 kernel
        (``ops.kernels.quant_matmul``)."""
        self._weight_quant = True

    def switch_ir_optim(self, flag: bool = True):
        """A no-op: the JAX package's one pass, the conv+BatchNorm fold
        (``inference/passes.py``), has nothing to fold in the port,
        which has no convolution or BatchNorm layer yet."""

    def enable_memory_optim(self, flag: bool = True):
        """A no-op, as in the JAX package, which stores the switch and
        never reads it: the caching allocator manages device memory."""

    # parity no-ops
    def set_cpu_math_library_num_threads(self, n: int):
        pass

    def disable_glog_info(self):
        pass

    def summary(self) -> str:
        src = f"layer:{type(self.layer).__name__}"
        return (f"source: {src}\nprecision: {self._precision}\n"
                f"weight_quant: {self._weight_quant}")


class _Handle:
    """Zero-copy style input/output handle."""

    def __init__(self, name: str, shape=None):
        self.name = name
        self._shape = tuple(shape) if shape else None
        self._value: Optional[np.ndarray] = None

    def reshape(self, shape: Sequence[int]):
        self._shape = tuple(shape)

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError("run() has not produced this output yet")
        return np.asarray(self._value)

    def shape(self):
        return self._shape if self._value is None else self._value.shape


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; from the card through page-locked memory,
    several times faster than a copy into pageable memory for the
    hundreds of megabytes of an MLM head's scores."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


class Predictor:
    """Runs a live layer with the configured passes applied."""

    def __init__(self, config: Config):
        if config.layer is None:
            raise ValueError("Config needs a layer (Config.from_layer)")
        self._config = config
        self._inputs: Dict[str, _Handle] = {}
        self._outputs: Dict[str, _Handle] = {}
        self._out_names: List[str] = []
        self._init_from_layer(config)

    def _init_from_layer(self, config: Config):
        from ..slim import quantize_weights
        layer = config.layer
        layer.eval()
        if config._weight_quant:
            quantize_weights(layer)
        self._bf16 = config._precision == PrecisionType.Bfloat16
        # a detached copy of the parameters and buffers taken now, as the
        # JAX predictor's param_arrays / buffer_arrays are
        # (paddle_tpu/inference/__init__.py:181-182): a layer that goes
        # on training, or that a later enable_int8() quantizes in place,
        # does not change this predictor; under bf16 the floating
        # parameters are cast, the buffers kept as they are
        params = {k: v.detach().clone() for k, v in layer.named_parameters()}
        if self._bf16:
            params = {k: v.to(torch.bfloat16) if v.is_floating_point()
                      else v for k, v in params.items()}
        self._state = {**params, **{k: b.detach().clone()
                                    for k, b in layer.named_buffers()}}
        self._device = next(layer.parameters()).device
        for i, s in enumerate(config.input_spec):
            # an object with .shape (the JAX InputSpec) or the shape
            self._inputs[f"x{i}"] = _Handle(f"x{i}", getattr(s, "shape", s))

    def _runner(self, *raw):
        inputs = []
        for a in raw:
            t = torch.as_tensor(a).to(self._device)
            if self._bf16 and t.is_floating_point():
                t = t.to(torch.bfloat16)
            inputs.append(t)
        with torch.inference_mode():
            out = functional_call(self._config.layer, self._state,
                                  tuple(inputs))
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return [o.float() if self._bf16 and o.is_floating_point() else o
                for o in outs]

    # -- API surface ---------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_input_handle(self, name: str) -> _Handle:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        return list(self._out_names)

    def get_output_handle(self, name: str) -> _Handle:
        return self._outputs[name]

    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        """Either pass arrays (returns the list of output arrays) or fill
        the input handles first (results land in the output handles)."""
        if inputs is None:
            vals = []
            for name, h in self._inputs.items():
                if h._value is None:
                    raise RuntimeError(f"input {name!r} not set; call "
                                       "get_input_handle(name)."
                                       "copy_from_cpu(arr) first")
                vals.append(h._value)
        else:
            vals = [np.asarray(v) for v in inputs]
        outs = [_to_host(o) for o in self._runner(*vals)]
        self._out_names = [f"out{i}" for i in range(len(outs))]
        self._outputs = {n: _Handle(n) for n in self._out_names}
        for n, o in zip(self._out_names, outs):
            self._outputs[n]._value = o
        return outs if inputs is not None else None

    def save_optimized_model(self, path: str):
        raise NotImplementedError(
            "save_optimized_model waits for the port of jit.save and io "
            "(ROADMAP Queue 1)")


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_serving_engine(config_or_layer, serving_config=None,
                          device=None):
    """The generation counterpart of :func:`create_predictor`: the port's
    ``serving.ServingEngine`` over a live GPT layer, or over a
    ``Config.from_layer`` whose ``enable_int8()`` applies
    ``slim.quantize_weights`` first (GPT keeps its weights as raw
    parameters, so no layer of it is quantized, as in the JAX package).
    ``enable_tpu_bf16()`` raises: the port's engine keeps float32
    parameters and pools only."""
    from ..serving import ServingConfig, ServingEngine
    if isinstance(config_or_layer, Config):
        cfg = config_or_layer
        if cfg._precision == PrecisionType.Bfloat16:
            raise NotImplementedError(
                "create_serving_engine with enable_tpu_bf16: the port's "
                "serving engine keeps float32 parameters and pools only "
                "(serving/engine.py); bf16 serving waits for its port")
        layer = cfg.layer
        if cfg._weight_quant:
            from ..slim import quantize_weights
            quantize_weights(layer)
    else:
        layer = config_or_layer
    return ServingEngine(layer, serving_config or ServingConfig(),
                         device=device)
