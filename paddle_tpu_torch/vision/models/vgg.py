"""VGG: counterpart of ``paddle_tpu/vision/models/vgg.py``.

The classifier's two dropouts go through the fused dropout kernel on the
card (``nn.functional.dropout``), drawing their seed words from the
active ``core.random.dropout_generator`` (``jit.TrainStep`` enters one);
a forward in training mode outside one raises. ``data_format="NHWC"``
converts the input to ``torch.channels_last`` at entry. Built on
``device`` (the card unless ``device="cpu"``) with weights from
``seed``.
"""

from __future__ import annotations

from ... import nn
from ...core.device import DeviceLike, resolve_device
from ...nn import functional as F
from ...nn import layout as _layout
from ._init import init_weights
from ...nn.layer import Layer

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False, device=None):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 data_format="NCHW", device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.features = features.to(dev)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = _layout.check_data_format(data_format)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, device=dev), nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096, device=dev), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, device=dev),
            )
        init_weights(self, seed, dev)

    def forward(self, x):
        if self.data_format == "NHWC":
            x = _layout.to_channels_last(x)
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, device=None, **kwargs):
    dev = resolve_device(device)
    return VGG(_make_layers(_CFGS[cfg], batch_norm, dev), device=dev,
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
