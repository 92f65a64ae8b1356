from .device import resolve_device
from .flags import flag_scope, get_flag, set_flags
from .random import dropout_generator, make_generator, seed_words

__all__ = ["dropout_generator", "flag_scope", "get_flag",
           "make_generator", "resolve_device", "seed_words", "set_flags"]
