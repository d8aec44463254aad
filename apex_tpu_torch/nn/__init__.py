"""Layers and functional ops (the subset ResNet and BERT need)."""

from torch.nn import ModuleList

from . import functional
from .layers import (AdaptiveAvgPool2d, BatchNorm2d, Conv2d, Dropout,
                     Embedding, LayerNorm, Linear, MaxPool2d)

__all__ = ["functional", "Conv2d", "Linear", "BatchNorm2d", "MaxPool2d",
           "AdaptiveAvgPool2d", "Embedding", "Dropout", "LayerNorm",
           "ModuleList"]
