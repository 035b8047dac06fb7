"""The plain reference of the multi-head pose model, in plain PyTorch.

A frozen copy of the published model (RegDA's ``PoseResNetx9``, the
reference's ``uda/model/regda_7.py``, on a torchvision ResNet): a Bottleneck
ResNet backbone, three stride-2 deconvolutions of 256 channels, a main head
and three adversarial heads (a plain head at 64², fusion heads out at 32²
and 16²). Its state-dict keys are the port's, so the benchmark hands both
the same tensors. Images and heatmaps are ``(B, H, W, C)``; inside, the
convolutions run NCHW on ``channels_last`` views, as the port lays them out.

``dtype`` is the compute dtype of the convolutions (parameters, batch-norm
statistics and labels stay float32). ``quant`` (a function of a tensor) is
applied to every convolution's input and weight before it computes: the
benchmark's lower-precision control sets it. Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (input, weight and bias cast)."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype
        self.quant = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        w, x = self.weight.to(dt), x.to(dt)
        if self.quant is not None:
            w, x = self.quant(w), self.quant(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, w, bias, self.stride, self.padding, self.dilation, self.groups)


class Deconv(nn.ConvTranspose2d):
    """Stride-2, kernel-4, padding-1 transposed convolution, no bias."""

    def __init__(self, cin, cout, dtype=None):
        super().__init__(cin, cout, 4, stride=2, padding=1, output_padding=0, bias=False)
        self.compute_dtype = dtype
        self.quant = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        w, x = self.weight.to(dt), x.to(dt)
        if self.quant is not None:
            w, x = self.quant(w), self.quant(x)
        return F.conv_transpose2d(x, w, None, self.stride, self.padding, self.output_padding)


def bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample, dtype):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False, dtype=dtype)
        self.bn1 = bn(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn2 = bn(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = bn(planes * 4)
        self.downsample = (nn.Sequential(Conv(cin, planes * 4, 1, stride=stride, bias=False,
                                              dtype=dtype), bn(planes * 4))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class Backbone(nn.Module):
    def __init__(self, layers, dtype):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = bn(64)
        cin, planes = 64, 64
        for li, n in enumerate(layers):
            blocks = []
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                blocks.append(Bottleneck(cin, planes, stride,
                                         stride != 1 or cin != planes * 4, dtype))
                cin = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.out_features = cin

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class Upsampling(nn.Sequential):
    def __init__(self, cin, dim, dtype):
        layers = []
        for _ in range(3):
            layers += [Deconv(cin, dim, dtype), bn(dim), nn.ReLU()]
            cin = dim
        super().__init__(*layers)


class PlainHead(nn.Sequential):
    def __init__(self, k, c, dtype):
        super().__init__(Conv(c, c, 3, padding=1, dtype=dtype), bn(c), nn.ReLU(),
                         Conv(c, k, 1, dtype=dtype))


class FusionHead(nn.Module):
    def __init__(self, k, c, stride, dtype):
        super().__init__()
        self.heatmap_conv = Conv(k, c, 1, dtype=dtype)
        self.feature_conv = (Conv(c, c, 1, dtype=dtype) if stride == 1 else
                             Conv(c, c, 3, stride=stride, padding=1, dtype=dtype))
        self.last_lay = nn.Sequential(
            bn(c), nn.ReLU(), Conv(c, c, 3, stride=2, padding=1, dtype=dtype), bn(c), nn.ReLU(),
            Conv(c, c, 1, dtype=dtype), bn(c), nn.ReLU())
        self.model = PlainHead(k, c, dtype)

    def forward(self, feature, heatmap):
        return self.model(self.last_lay(self.heatmap_conv(heatmap) + self.feature_conv(feature)))


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies by ``coeff`` in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, coeff):
        ctx.coeff = coeff.to(x.dtype)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.coeff, None


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class PoseModel(nn.Module):
    """The multi-head model: ``features``, ``main_head``, ``adv_heads``."""

    def __init__(self, layers, num_keypoints=21, feature_dim=256, dtype=None):
        super().__init__()
        k, c = num_keypoints, feature_dim
        self.backbone = Backbone(layers, dtype)
        self.upsampling = Upsampling(self.backbone.out_features, c, dtype)
        self.head = PlainHead(k, c, dtype)
        self.head_adv = PlainHead(k, c, dtype)
        self.head_adv2 = FusionHead(k, c, 1, dtype)
        self.head_adv3 = FusionHead(k, c, 2, dtype)

    def set_quant(self, fn) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, Deconv)):
                m.quant = fn

    def features(self, x):
        return nhwc(self.upsampling(self.backbone(nchw(x))))

    def main_head(self, f):
        return nhwc(self.head(nchw(f)))

    def adv_heads(self, f, coeff):
        f_adv = _ScaleGrad.apply(nchw(f), coeff)
        y1 = self.head_adv(f_adv)
        y2 = self.head_adv2(f_adv, y1)
        y3 = self.head_adv3(f_adv, y2)
        return {"y_adv": nhwc(y1), "y_adv2": nhwc(y2), "y_adv3": nhwc(y3)}

    def forward(self, x, coeff):
        f = self.features(x)
        return {"y": self.main_head(f), **self.adv_heads(f, coeff)}
