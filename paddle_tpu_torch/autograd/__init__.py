"""``paddle.autograd``: counterpart of ``paddle_tpu/autograd``."""

from ..core.tensor import (backward, enable_grad, is_grad_enabled,  # noqa
                           no_grad, set_grad_enabled)
from .functional import grad, hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad", "grad",
           "hessian", "is_grad_enabled", "jacobian", "jvp", "no_grad",
           "set_grad_enabled", "vjp"]
