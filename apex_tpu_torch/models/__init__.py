"""Models of the port (the ResNet family so far)."""

from .resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet50

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet50"]
