from .to_static import TrainStep

__all__ = ["TrainStep"]
