from .adam import Adam, AdamW
from .clip import ClipGradByGlobalNorm
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "Optimizer"]
