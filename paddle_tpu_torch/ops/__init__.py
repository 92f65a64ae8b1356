"""Attention dispatch and the hand-written CUDA kernels."""

from .attention import sdpa_array

__all__ = ["sdpa_array"]
