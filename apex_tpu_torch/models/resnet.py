"""ResNet family (torchvision's v1 structure: stride 2 in the bottleneck's
3x3), the model of the imagenet example and the training benchmark.

Counterpart of ``apex_tpu/models/resnet.py``: ``resnet18/34/50/101/152``,
in two layouts and with two stems.

- ``channels_last=False`` (the default) runs every activation NCHW; with
  ``channels_last=True`` every internal activation is NHWC, each conv and
  pool running on its channels-last view (``nn.functional``), and the
  BatchNorms normalize over ``channel_axis=-1``.  An NCHW input is then
  transposed once at entry, a real copy, as the JAX package's transpose
  is; ``input_format="NHWC"`` (which needs ``channels_last``) takes NHWC
  batches as they are, so the pipeline has no transpose at all.
- ``stem="conv7"`` is torchvision's 7x7 stride-2 conv on 3 channels;
  ``stem="space_to_depth"`` is the exact rewrite: a 2x2 space-to-depth
  of the input (3 -> 12 channels, half the height and width), then a 4x4
  stride-1 conv padded ((2, 1), (2, 1)).  ``stem_weight_to_s2d`` embeds a
  conv7 weight into it exactly; ``convert_stem_to_s2d`` does so for a
  state dict.

Parameter and buffer names are the JAX package's tree paths, which are
torchvision's (``layer1.0.downsample.0.weight``, ``bn1.running_mean``,
...), and their shapes are the same in every mode: conv weights OIHW,
BatchNorm parameters (C,).  So ``utils.jax_interop`` maps one model's
weights onto the other's, and checkpoints and amp are layout-agnostic.
The NHWC model runs no syncbn kernel: its BatchNorms take the plain
route, as the JAX package's do for ``channel_axis != 1``.

The constructors build on ``cuda`` unless ``device`` says otherwise, and
draw the weights from ``generator`` (default: a CPU generator seeded 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

import torch

from .. import nn
from .._device import resolve_device

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "stem_weight_to_s2d",
           "convert_stem_to_s2d"]


def conv3x3(cin, cout, stride=1, **kw):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, **kw)


def conv1x1(cin, cout, stride=1, **kw):
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False, **kw)


def _bn(planes, data_format, device):
    return nn.BatchNorm2d(planes, channel_axis=1 if data_format == "NCHW"
                          else -1, device=device)


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 data_format="NCHW", *, device, generator):
        super().__init__()
        kw = dict(data_format=data_format, device=device, generator=generator)
        self.conv1 = conv3x3(inplanes, planes, stride, **kw)
        self.bn1 = _bn(planes, data_format, device)
        self.conv2 = conv3x3(planes, planes, **kw)
        self.bn2 = _bn(planes, data_format, device)
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

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 data_format="NCHW", *, device, generator):
        super().__init__()
        kw = dict(data_format=data_format, device=device, generator=generator)
        self.conv1 = conv1x1(inplanes, planes, **kw)
        self.bn1 = _bn(planes, data_format, device)
        self.conv2 = conv3x3(planes, planes, stride, **kw)
        self.bn2 = _bn(planes, data_format, device)
        self.conv3 = conv1x1(planes, planes * self.expansion, **kw)
        self.bn3 = _bn(planes * self.expansion, data_format, device)
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
                 num_classes: int = 1000, channels_last: bool = False,
                 input_format: str = "NCHW", stem: str = "conv7", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_format not in ("NCHW", "NHWC"):
            raise ValueError(f"input_format must be NCHW or NHWC, "
                             f"got {input_format!r}")
        if input_format == "NHWC" and not channels_last:
            raise ValueError("input_format='NHWC' requires "
                             "channels_last=True")
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"stem must be 'conv7' or 'space_to_depth', "
                             f"got {stem!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.channels_last = channels_last
        self.input_format = input_format
        self.stem = stem
        df = self.data_format = "NHWC" if channels_last else "NCHW"
        kw = dict(data_format=df, device=device, generator=generator)
        self.inplanes = 64
        if stem == "space_to_depth":
            # out(i) reads s2d rows i-2 .. i+1 (u = 2*pk + a - 1, see
            # stem_weight_to_s2d): pad 2 before and 1 after
            self.conv1 = nn.Conv2d(12, 64, 4, stride=1,
                                   padding=((2, 1), (2, 1)), bias=False, **kw)
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                   **kw)
        self.bn1 = _bn(64, df, device)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1, data_format=df)
        self.layer1 = self._make_layer(block, 64, layers[0], **kw)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2, **kw)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2, **kw)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, **kw)
        self.avgpool = nn.AdaptiveAvgPool2d(1, data_format=df)
        self.fc = nn.Linear(512 * block.expansion, num_classes, device=device,
                            generator=generator)

    def _make_layer(self, block, planes, blocks, stride=1, **kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = torch.nn.Sequential(
                conv1x1(self.inplanes, planes * block.expansion, stride, **kw),
                _bn(planes * block.expansion, kw["data_format"],
                    kw["device"]))
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return torch.nn.Sequential(*layers)

    def forward(self, x):
        if self.channels_last and self.input_format == "NCHW":
            x = x.permute(0, 2, 3, 1).contiguous()
        if self.stem == "space_to_depth":
            x = nn.functional.space_to_depth(x, 2, self.data_format)
        x = nn.functional.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        x = x.reshape(x.shape[0], -1)
        return self.fc(x)


def stem_weight_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """Embed a (64, 3, 7, 7) OIHW stem weight exactly into the (64, 12, 4,
    4) weight of the space-to-depth stem.

    The conv7 output is ``sum_u w7[u] * x[2i + u - 3]`` (stride 2, pad
    3).  After the 2x2 space-to-depth, position ``i + pk - 2`` of the
    padded s2d input holds row ``2i + 2*pk - 4 + a`` of x, so ``u = 2*pk +
    a - 1`` (and ``v = 2*qk + bb - 1``); ``u = -1`` falls outside the
    7-tap kernel and stays zero: 147 of the 192 taps a filter are set.
    The s2d channel index is ``a*(2*C) + bb*C + c``, the order of
    ``nn.functional.space_to_depth`` in both layouts."""
    O, C, KH, KW = w7.shape
    if (KH, KW) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {(KH, KW)}")
    w4 = w7.new_zeros((O, 4 * C, 4, 4))
    for a in range(2):
        for bb in range(2):
            cidx = a * (2 * C) + bb * C
            for pk in range(4):
                u = 2 * pk + a - 1
                if not 0 <= u < 7:
                    continue
                for qk in range(4):
                    v = 2 * qk + bb - 1
                    if 0 <= v < 7:
                        w4[:, cidx:cidx + C, pk, qk] = w7[:, :, u, v]
    return w4


def convert_stem_to_s2d(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A conv7 model's state dict for a ``stem="space_to_depth"`` model of
    the same function: only ``conv1.weight`` changes (a new dict; every
    other tensor shared)."""
    out = dict(state_dict)
    out["conv1.weight"] = stem_weight_to_s2d(state_dict["conv1.weight"])
    return out


def resnet18(num_classes=1000, channels_last=False, input_format="NCHW",
             stem="conv7", *, device=None, generator=None):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, channels_last,
                  input_format, stem, device=device, generator=generator)


def resnet34(num_classes=1000, channels_last=False, input_format="NCHW",
             stem="conv7", *, device=None, generator=None):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, channels_last,
                  input_format, stem, device=device, generator=generator)


def resnet50(num_classes=1000, channels_last=False, input_format="NCHW",
             stem="conv7", *, device=None, generator=None):
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, channels_last,
                  input_format, stem, device=device, generator=generator)


def resnet101(num_classes=1000, channels_last=False, input_format="NCHW",
              stem="conv7", *, device=None, generator=None):
    return ResNet(Bottleneck, [3, 4, 23, 3], num_classes, channels_last,
                  input_format, stem, device=device, generator=generator)


def resnet152(num_classes=1000, channels_last=False, input_format="NCHW",
              stem="conv7", *, device=None, generator=None):
    return ResNet(Bottleneck, [3, 8, 36, 3], num_classes, channels_last,
                  input_format, stem, device=device, generator=generator)
