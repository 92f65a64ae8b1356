from . import chunked_ce, functional

__all__ = ["chunked_ce", "functional"]
