from .device import resolve_device
from .random import dropout_generator, make_generator, seed_words

__all__ = ["dropout_generator", "make_generator", "resolve_device",
           "seed_words"]
