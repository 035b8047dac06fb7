"""Headless ResNet backbones (stem + layer1..4, stride-32 features).

Port of ``dahpe_tpu/models/resnet.py`` (the reference's
``uda/model/resnet.py``). Attribute names are the torch state-dict keys
(``conv1 / bn1 / layerN.i.convJ / ... / downsample.{0,1}``), so a reference
``.pth`` loads with a plain ``load_state_dict``. The modules run NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(
        cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False
    )


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            _downsample(inplanes, planes * self.expansion, stride) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            _downsample(inplanes, planes * self.expansion, stride) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """Headless ResNet: ``(B, 3, H, W)`` → ``(B, out_features, H/32, W/32)``."""

    def __init__(self, block: type, layers: Sequence[int], groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.block = block
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = 64, 64
        for li, n_blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                blk_stride = stride if bi == 0 else 1
                needs_ds = blk_stride != 1 or inplanes != planes * block.expansion
                blocks.append(block(inplanes, planes, blk_stride, needs_ds,
                                    groups, base_width))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2

    @property
    def out_features(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def _make(block, layers, **kw):
    def ctor():
        return ResNet(block, layers, **kw)

    return ctor


resnet18 = _make(BasicBlock, [2, 2, 2, 2])
resnet34 = _make(BasicBlock, [3, 4, 6, 3])
resnet50 = _make(Bottleneck, [3, 4, 6, 3])
resnet101 = _make(Bottleneck, [3, 4, 23, 3])
resnet152 = _make(Bottleneck, [3, 8, 36, 3])
resnext50_32x4d = _make(Bottleneck, [3, 4, 6, 3], groups=32, base_width=4)
resnext101_32x8d = _make(Bottleneck, [3, 4, 23, 3], groups=32, base_width=8)
wide_resnet50_2 = _make(Bottleneck, [3, 4, 6, 3], base_width=128)
wide_resnet101_2 = _make(Bottleneck, [3, 4, 23, 3], base_width=128)
