"""Containers (counterpart of ``paddle_tpu/nn/layer.py::Sequential``,
:325, and its ``LayerList`` / ``ParameterList`` / ``LayerDict``): they
live in ``nn/layer.py`` beside ``Layer``, as in the JAX package."""

from ..layer import LayerDict, LayerList, ParameterList, Sequential

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]
