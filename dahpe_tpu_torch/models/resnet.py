"""Headless ResNet backbones (stem + layer1..4, stride-32 features).

Port of ``dahpe_tpu/models/resnet.py`` (the reference's
``uda/model/resnet.py``). Attribute names are the torch state-dict keys
(``conv1 / bn1 / layerN.i.convJ / ... / downsample.{0,1}``), so a reference
``.pth`` loads with a plain ``load_state_dict``. The modules run NCHW. The
convs start from the JAX package's initialisation (:func:`conv_init_`).

``dtype`` is the compute dtype, as the Flax modules' ``dtype``: with
``torch.bfloat16`` every conv casts its input and its float32 weight to
bfloat16 and returns bfloat16 (:class:`Conv2d`), and batch norm keeps
float32 statistics (:mod:`dahpe_tpu_torch.models.batch_norm`). Each batch
norm runs with the ReLU and the residual add after it as one
``batch_norm_act`` (:mod:`dahpe_tpu_torch.ops.batch_norm_act`). ``None``
computes in the weights' dtype, float32, with the operations of a plain
``nn.Conv2d``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d
from dahpe_tpu_torch.ops.batch_norm_act import batch_norm_act


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype (Flax's ``nn.Conv(dtype=...)``):
    the input, the weight and the bias are cast to it and the result is in
    it; the parameters stay float32, and their gradients arrive in float32
    through the casts. ``None`` computes in the weight's dtype, where the
    casts return their tensors unchanged: ``nn.Conv2d``'s own operations."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def conv_init_(conv: nn.Conv2d) -> nn.Conv2d:
    """The JAX package's ResNet conv init (``dahpe_tpu/models/resnet.py:21``,
    Kaiming-normal fan_out as torchvision's ResNets): a normal truncated at
    two standard deviations, scaled so its variance is 2 / fan_out."""
    fan_out = conv.weight.shape[0] * conv.weight[0, 0].numel()
    std = (2.0 / fan_out) ** 0.5 / 0.87962566103423978  # the truncation's variance
    nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std, b=2.0 * std)
    return conv


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          dtype: torch.dtype | None = None) -> Conv2d:
    return conv_init_(Conv2d(
        cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False,
        compute_dtype=dtype,
    ))


def _downsample(cin: int, cout: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride, dtype=dtype), BatchNorm2d(cout))


def _identity(downsample: nn.Sequential | None, x: torch.Tensor) -> torch.Tensor:
    """A block's residual: ``x``, or its downsampling (conv, then batch norm
    without a ReLU)."""
    if downsample is None:
        return x
    return batch_norm_act(downsample[0](x), downsample[1], relu=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            _downsample(inplanes, planes * self.expansion, stride, dtype) if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = _identity(self.downsample, x)
        out = batch_norm_act(self.conv1(x), self.bn1, relu=True)
        return batch_norm_act(self.conv2(out), self.bn2, relu=True, residual=identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64,
                 dtype: torch.dtype | None = None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, groups, dtype=dtype)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, planes * self.expansion, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            _downsample(inplanes, planes * self.expansion, stride, dtype) if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = _identity(self.downsample, x)
        out = batch_norm_act(self.conv1(x), self.bn1, relu=True)
        out = batch_norm_act(self.conv2(out), self.bn2, relu=True)
        return batch_norm_act(self.conv3(out), self.bn3, relu=True, residual=identity)


class ResNet(nn.Module):
    """Headless ResNet: ``(B, 3, H, W)`` → ``(B, out_features, H/32, W/32)``."""

    def __init__(self, block: type, layers: Sequence[int], groups: int = 1,
                 base_width: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        self.block = block
        self.conv1 = conv_init_(Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                       compute_dtype=dtype))
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
                                    groups, base_width, dtype))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2

    @property
    def out_features(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(batch_norm_act(self.conv1(x), self.bn1, relu=True))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def _make(block, layers, **kw):
    def ctor(dtype: torch.dtype | None = None):
        return ResNet(block, layers, dtype=dtype, **kw)

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
