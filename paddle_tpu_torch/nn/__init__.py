from . import chunked_ce, functional, initializer, layers, layout, quant
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers_all
from .decode import (BeamSearchDecoder, Decoder, dynamic_decode,
                     gather_tree)

__all__ = ["BeamSearchDecoder", "Decoder", "chunked_ce", "dynamic_decode",
           "functional", "gather_tree", "initializer", "layers", "layout",
           "quant"] + _layers_all
