"""The vision model zoo (counterpart of ``paddle_tpu.vision.models``),
with the JAX package's state-dict keys and shapes, so
``models.load_jax_weights`` carries a JAX model's arrays across."""

from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "MobileNetV1", "MobileNetV2", "ResNet", "VGG",
           "mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "vgg11", "vgg13", "vgg16",
           "vgg19"]
