"""MobileNet V1/V2: counterpart of ``paddle_tpu/vision/models/mobilenet.py``.

Each conv -> BN -> ReLU6 triple runs through ``nn.fused_conv_bn_act``;
``data_format="NHWC"`` converts the input to ``torch.channels_last`` at
entry. MobileNetV2's classifier dropout (0.2) goes through the fused
dropout kernel on the card. Built on ``device`` (the card unless
``device="cpu"``) with weights from ``seed``.
"""

from __future__ import annotations

from ... import nn
from ...core.device import DeviceLike, resolve_device
from ...nn import functional as F
from ...nn import layout as _layout
from ._init import init_weights
from ...nn.layer import Layer

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class _ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 device=None):
        pad = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                      groups=groups, bias_attr=False, device=device),
            nn.BatchNorm2D(out_c, device=device),
            nn.ReLU6(),
        )

    def forward(self, x):
        conv, bn, _ = self._modules.values()
        return nn.fused_conv_bn_act(conv, bn, x, "relu6")


class _DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c, stride, device=None):
        super().__init__()
        self.dw = _ConvBNReLU(in_c, in_c, 3, stride, groups=in_c,
                              device=device)
        self.pw = _ConvBNReLU(in_c, out_c, 1, 1, device=device)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = _layout.check_data_format(data_format)

        def s(c):
            return max(int(c * scale), 8)

        cfg = [(s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
               (s(128), s(256), 2), (s(256), s(256), 1),
               (s(256), s(512), 2)] + [(s(512), s(512), 1)] * 5 + \
            [(s(512), s(1024), 2), (s(1024), s(1024), 1)]
        layers = [_ConvBNReLU(3, s(32), 3, 2, device=dev)]
        for in_c, out_c, stride in cfg:
            layers.append(_DepthwiseSeparable(in_c, out_c, stride,
                                              device=dev))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, device=dev)
        init_weights(self, seed, dev)

    def forward(self, x):
        if self.data_format == "NHWC":
            x = _layout.to_channels_last(x)
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


class _InvertedResidual(Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio, device=None):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1, device=device))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride, groups=hidden,
                        device=device),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False, device=device),
            nn.BatchNorm2D(out_c, device=device),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = _layout.check_data_format(data_format)
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        in_c = max(int(32 * scale), 8)
        last_c = max(int(1280 * scale), 1280)
        layers = [_ConvBNReLU(3, in_c, 3, 2, device=dev)]
        for t, c, n, s in cfg:
            out_c = max(int(c * scale), 8)
            for i in range(n):
                layers.append(_InvertedResidual(in_c, out_c,
                                                s if i == 0 else 1, t,
                                                device=dev))
                in_c = out_c
        layers.append(_ConvBNReLU(in_c, last_c, 1, device=dev))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_c, num_classes, device=dev))
        init_weights(self, seed, dev)

    def forward(self, x):
        if self.data_format == "NHWC":
            x = _layout.to_channels_last(x)
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
