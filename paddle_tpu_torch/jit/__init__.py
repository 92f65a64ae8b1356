from .save_load import TranslatedLayer, load, save
from .to_static import TrainStep

__all__ = ["TrainStep", "TranslatedLayer", "load", "save"]
