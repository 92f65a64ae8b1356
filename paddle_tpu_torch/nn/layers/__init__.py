"""Layers (counterpart of ``paddle_tpu.nn.layers``): the ones the GPT,
BERT and ERNIE models and the vision zoo are built from."""

from .activation import ReLU, ReLU6, Sigmoid, Tanh
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                   Conv3D, Conv3DTranspose, fused_conv_bn_act)
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                      MaxUnPool2D)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv1DTranspose",
           "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "CrossEntropyLoss", "Dropout", "Embedding", "Flatten", "Identity",
           "LayerDict", "LayerList", "LayerNorm", "Linear", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "MaxUnPool2D", "MultiHeadAttention",
           "ParameterList", "ReLU", "ReLU6", "Sequential", "Sigmoid",
           "SyncBatchNorm",
           "Tanh", "TransformerEncoder", "TransformerEncoderLayer",
           "fused_conv_bn_act"]
