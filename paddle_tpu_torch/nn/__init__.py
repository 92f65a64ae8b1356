from . import chunked_ce, functional, layers, quant

__all__ = ["chunked_ce", "functional", "layers", "quant"]
