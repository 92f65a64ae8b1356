from . import lr
from .adam import Adam, AdamW
from .clip import ClipGradByGlobalNorm
from .optimizer import Optimizer
from .sgd import SGD, Momentum

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "Momentum",
           "Optimizer", "SGD", "lr"]
