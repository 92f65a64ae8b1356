"""ResNet family: counterpart of ``paddle_tpu/vision/models/resnet.py``.

The JAX package's blocks, names and state-dict layout (``conv1.weight``,
``bn1._mean``, ``layer1.0.downsample.0.weight``, ``fc.weight [in,
out]``; no conv bias). Each conv -> BN (-> ReLU) triple runs through
``nn.fused_conv_bn_act``. ``data_format="NHWC"`` converts the input to
``torch.channels_last`` at entry, so every conv, BN and pool runs NHWC in
memory while the input and output keep their logical NCHW shapes
(``resnet.py:152-175``). Built on ``device`` (the card unless
``device="cpu"``) with weights from ``seed``.
"""

from __future__ import annotations

import functools

from ... import nn
from ...core.device import DeviceLike, resolve_device
from ...nn import functional as F
from ...nn import layout as _layout
from ._init import init_weights
from ...nn.layer import Layer

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(nn.BatchNorm2D,
                                                     device=device)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, device=device)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               device=device)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = nn.fused_conv_bn_act(self.conv1, self.bn1, x, "relu")
        out = nn.fused_conv_bn_act(self.conv2, self.bn2, out, None)
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(nn.BatchNorm2D,
                                                     device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               device=device)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False,
                               device=device)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, device=device)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = nn.fused_conv_bn_act(self.conv1, self.bn1, x, "relu")
        out = nn.fused_conv_bn_act(self.conv2, self.bn2, out, "relu")
        out = nn.fused_conv_bn_act(self.conv3, self.bn3, out, None)
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW",
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        layer_cfg = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
        }
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        self.data_format = _layout.check_data_format(data_format)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._device = dev
        self._norm_layer = functools.partial(nn.BatchNorm2D, device=dev)
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, device=dev)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=dev)
        init_weights(self, seed, dev)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        dev = self._device
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, device=dev),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, 1, norm_layer, device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, device=dev))
        return nn.Sequential(*layers)

    def forward(self, x):
        if self.data_format == "NHWC":
            x = _layout.to_channels_last(x)
        x = nn.fused_conv_bn_act(self.conv1, self.bn1, x, "relu")
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def _resnet(block, depth, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)
