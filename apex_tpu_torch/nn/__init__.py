"""Layers and functional ops (the subset ResNet needs)."""

from . import functional
from .layers import (AdaptiveAvgPool2d, BatchNorm2d, Conv2d, Linear,
                     MaxPool2d)

__all__ = ["functional", "Conv2d", "Linear", "BatchNorm2d", "MaxPool2d",
           "AdaptiveAvgPool2d"]
