"""Inference weight passes: counterpart of ``paddle_tpu/inference/passes.py``.

At inference time a BatchNorm is an affine map with frozen statistics,
so it folds into the convolution before it exactly:

    w' = w * gamma / sqrt(var + eps)        (per out-channel)
    b' = beta + (b - mean) * gamma / sqrt(var + eps)

after which the BatchNorm is replaced by ``Identity``: one convolution,
no separate normalisation traffic. ``inference.Predictor`` applies it
under ``Config.switch_ir_optim`` (on by default), as the JAX predictor
does.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["fold_conv_bn"]


def _fold_containers():
    """Container types where child-declaration adjacency IS dataflow
    adjacency: ``Sequential`` runs its children in order, and the zoo's
    ResNet blocks wire convN straight into bnN. Elsewhere a conv may sit
    beside a BatchNorm it never feeds, so the default pass leaves it."""
    from ..nn.layers.container import Sequential
    from ..vision.models.resnet import (BasicBlock, BottleneckBlock,
                                        ResNet)
    return (Sequential, ResNet, BasicBlock, BottleneckBlock)


@torch.no_grad()
def fold_conv_bn(layer: nn.Module, aggressive: bool = False) -> int:
    """Fold every (Conv2D, BatchNorm) pair of adjacent children into the
    conv and replace the BatchNorm with ``Identity``, through the whole
    module tree; only inside the containers of :func:`_fold_containers`
    unless ``aggressive``; a ``SyncBatchNorm`` stays, as in the JAX pass.
    Mutates ``layer`` in place (call it on an
    eval-mode model); returns the number of pairs folded."""
    from ..nn.layers.common import Identity
    from ..nn.layers.conv import Conv2D
    from ..nn.layers.norm import SyncBatchNorm, _BatchNormBase

    folded = 0
    children = list(layer._modules.items())
    if aggressive or isinstance(layer, _fold_containers()):
        for (_, a), (name_b, b) in zip(children, children[1:]):
            if not (type(a) is Conv2D and isinstance(b, _BatchNormBase)
                    and not isinstance(b, SyncBatchNorm)):
                continue
            mean = b._mean.float()
            gamma = b.weight.float() if b.weight is not None \
                else torch.ones_like(mean)
            beta = b.bias.float() if b.bias is not None \
                else torch.zeros_like(mean)
            scale = gamma / torch.sqrt(b._variance.float() + b._epsilon)
            w = a.weight
            # [out, in/groups, kh, kw]: scale over the out-channel axis
            w.copy_(w.float() * scale.view((-1,) + (1,) * (w.dim() - 1)))
            old_b = a.bias.float() if a.bias is not None \
                else torch.zeros_like(mean)
            new_b = beta + (old_b - mean) * scale
            if a.bias is not None:
                a.bias.copy_(new_b)
            else:
                a.bias = nn.Parameter(new_b, requires_grad=False)
            layer._modules[name_b] = Identity()
            folded += 1
    for child in layer._modules.values():
        if child is not None:
            folded += fold_conv_bn(child, aggressive=aggressive)
    return folded
