"""LeNet: counterpart of ``paddle_tpu/vision/models/lenet.py``.

Built on ``device`` (the card unless ``device="cpu"``) with weights from
``seed``. ``data_format="NHWC"`` runs the conv stack channels-last (the
input is converted to ``torch.channels_last`` at entry); the logical
NCHW contract holds on both ends either way.
"""

from __future__ import annotations

from ... import nn
from ...core.device import DeviceLike, resolve_device
from ...nn import functional as F
from ...nn import layout as _layout
from ._init import init_weights
from ...nn.layer import Layer

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, data_format="NCHW",
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.data_format = _layout.check_data_format(data_format)
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, device=dev),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, device=dev),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, device=dev),
                nn.Linear(120, 84, device=dev),
                nn.Linear(84, num_classes, device=dev),
            )
        init_weights(self, seed, dev)

    def forward(self, inputs):
        if self.data_format == "NHWC":
            inputs = _layout.to_channels_last(inputs)
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x
