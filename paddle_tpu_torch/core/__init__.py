from .device import resolve_device
from .random import make_generator

__all__ = ["make_generator", "resolve_device"]
