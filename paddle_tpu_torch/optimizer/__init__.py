from .adam import Adam, AdamW
from .clip import ClipGradByGlobalNorm
from .optimizer import Optimizer
from .sgd import SGD

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "Optimizer", "SGD"]
