"""The layer library and its functional ops."""

from torch.nn import ModuleList

from . import functional
from .layers import (AdaptiveAvgPool2d, AvgPool2d, BatchNorm2d, Conv2d,
                     ConvTranspose2d, Dropout, Embedding, Flatten, GELU,
                     Identity, LayerNorm, LeakyReLU, Linear, MaxPool2d, ReLU,
                     Sigmoid, Tanh)

__all__ = ["functional", "Linear", "Conv2d", "ConvTranspose2d",
           "BatchNorm2d", "LayerNorm", "Embedding", "Dropout", "ReLU",
           "LeakyReLU", "GELU", "Tanh", "Sigmoid", "Identity", "Flatten",
           "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d", "ModuleList"]
