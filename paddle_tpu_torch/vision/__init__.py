"""Vision (counterpart of ``paddle_tpu.vision``): the model zoo
(``models``: LeNet, ResNet-18/34/50/101/152, VGG-11/13/16/19,
MobileNetV1/V2), synthetic and local-file ``datasets`` and numpy
``transforms``. ``vision.ops`` and the detection modules are not ported
yet."""

from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
