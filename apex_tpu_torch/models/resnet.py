"""ResNet family (torchvision's v1 structure: stride 2 in the bottleneck's
3x3), the model of the imagenet example and the training benchmark.

Counterpart of ``apex_tpu/models/resnet.py`` with its NCHW ``conv7``
stem.  Parameter and buffer names are the JAX package's tree paths,
which are torchvision's (``layer1.0.downsample.0.weight``,
``bn1.running_mean``, ...), so ``utils.jax_interop`` maps one model's
weights onto the other's.  (``channels_last`` and the space-to-depth stem
are not ported yet.)

The constructors build on ``cuda`` unless ``device`` says otherwise, and
draw the weights from ``generator`` (default: a CPU generator seeded 0).
"""

from __future__ import annotations

from typing import List, Optional, Type

import torch

from .. import nn
from .._device import resolve_device

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet50"]


def conv3x3(cin, cout, stride=1, **kw):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, **kw)


def conv1x1(cin, cout, stride=1, **kw):
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False, **kw)


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = conv3x3(inplanes, planes, stride, **kw)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = conv3x3(planes, planes, **kw)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = nn.functional.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return nn.functional.relu(out + identity)


class Bottleneck(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = conv1x1(inplanes, planes, **kw)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = conv3x3(planes, planes, stride, **kw)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.conv3 = conv1x1(planes, planes * self.expansion, **kw)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = nn.functional.relu(self.bn1(self.conv1(x)))
        out = nn.functional.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return nn.functional.relu(out + identity)


class ResNet(torch.nn.Module):
    def __init__(self, block: Type[torch.nn.Module], layers: List[int],
                 num_classes: int = 1000, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], **kw)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2, **kw)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2, **kw)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, **kw)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, *, device,
                    generator):
        kw = dict(device=device, generator=generator)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = torch.nn.Sequential(
                conv1x1(self.inplanes, planes * block.expansion, stride, **kw),
                nn.BatchNorm2d(planes * block.expansion, device=device))
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return torch.nn.Sequential(*layers)

    def forward(self, x):
        x = nn.functional.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        x = x.reshape(x.shape[0], -1)
        return self.fc(x)


def resnet18(num_classes=1000, *, device=None, generator=None):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, device=device,
                  generator=generator)


def resnet50(num_classes=1000, *, device=None, generator=None):
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, device=device,
                  generator=generator)
