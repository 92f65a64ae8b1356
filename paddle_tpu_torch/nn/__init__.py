from . import chunked_ce, functional, layers

__all__ = ["chunked_ce", "functional", "layers"]
