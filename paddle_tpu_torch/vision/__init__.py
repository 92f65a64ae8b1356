"""Vision (counterpart of ``paddle_tpu.vision``): the model zoo
(``models``: LeNet, ResNet-18/34/50/101/152, VGG-11/13/16/19,
MobileNetV1/V2), synthetic and local-file ``datasets``, numpy
``transforms``, and the vision and detection operators (``ops``, with
``detection`` and ``detection_extra``)."""

# ops first: it re-exports the two detection modules, which import it
from . import ops  # noqa: I001
from . import datasets, detection, detection_extra, models, transforms

__all__ = ["datasets", "detection", "detection_extra", "models", "ops",
           "transforms"]
