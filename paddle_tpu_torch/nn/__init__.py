from . import chunked_ce, functional, layers, quant
from .decode import (BeamSearchDecoder, Decoder, dynamic_decode,
                     gather_tree)

__all__ = ["BeamSearchDecoder", "Decoder", "chunked_ce", "dynamic_decode",
           "functional", "gather_tree", "layers", "quant"]
