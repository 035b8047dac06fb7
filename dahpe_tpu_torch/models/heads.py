"""Regression heads: the plain per-scale head and the two multiscale fusion
heads of the reference's cascade.

Port of ``dahpe_tpu/models/heads.py``. Parity targets in the reference:
plain head ``regda_7.py:4906-4929``, 64→32 fusion ``regda_7.py:4508-4581``,
→16 fusion ``regda_7.py:4583-4662``. Submodules are torch Sequential indices,
so ``.pth`` keys load unchanged (e.g. ``head_adv2.last_lay.2.weight``).
Every conv starts from the JAX package's ``head_init`` (:func:`head_init_`).
``dtype`` is the compute dtype, as in :mod:`dahpe_tpu_torch.models.resnet`.
"""

from __future__ import annotations

import torch
from torch import nn

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d, bn_relu_sequence
from dahpe_tpu_torch.models.resnet import Conv2d


def head_init_(module: nn.Module) -> nn.Module:
    """The JAX package's head and deconv init (``head_init``,
    ``dahpe_tpu/models/heads.py:9``, the reference's ``init_weights``):
    every conv and transposed conv of ``module`` gets weights ~ N(0, 1e-3²)
    and zero biases; BN layers keep ones and zeros."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.normal_(m.weight, std=1e-3)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


class PlainHead(nn.Sequential):
    """[Conv3x3 → BN → ReLU] x (num_layers-1) → Conv1x1(C→K)."""

    def __init__(self, num_keypoints: int, num_layers: int = 2, channel_dim: int = 256,
                 dtype: torch.dtype | None = None):
        layers = []
        for _ in range(num_layers - 1):
            layers += [Conv2d(channel_dim, channel_dim, 3, padding=1, compute_dtype=dtype),
                       BatchNorm2d(channel_dim), nn.ReLU(inplace=True)]
        layers.append(Conv2d(channel_dim, num_keypoints, 1, compute_dtype=dtype))
        super().__init__(*layers)
        head_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_relu_sequence(self, x)


class DownsampleStage(nn.Sequential):
    """[BN, ReLU, Conv3x3 s2, BN, ReLU, Conv1x1, BN, ReLU]: one stride-2 block
    halving the spatial size (``regda_7.py:4544-4571``)."""

    def __init__(self, channel_dim: int = 256, dtype: torch.dtype | None = None):
        c = channel_dim
        super().__init__(
            BatchNorm2d(c), nn.ReLU(inplace=True),
            Conv2d(c, c, 3, stride=2, padding=1, compute_dtype=dtype), BatchNorm2d(c),
            nn.ReLU(inplace=True),
            Conv2d(c, c, 1, compute_dtype=dtype), BatchNorm2d(c), nn.ReLU(inplace=True),
        )
        head_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_relu_sequence(self, x)


class FusionHead(nn.Module):
    """Adversarial fusion head: previous heatmap + features → half-res heatmap.

    ``feature_stride=1`` is ``make_head`` (head_adv2: fused at 64, out at 32);
    ``feature_stride=2`` is ``make_head2`` (head_adv3: features 64→32 by a
    strided 3x3, fused at 32, out at 16).
    """

    def __init__(self, num_keypoints: int, feature_stride: int = 1,
                 num_layers: int = 2, channel_dim: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c = channel_dim
        self.heatmap_conv = Conv2d(num_keypoints, c, 1, compute_dtype=dtype)
        if feature_stride == 1:
            self.feature_conv = Conv2d(c, c, 1, compute_dtype=dtype)
        else:
            self.feature_conv = Conv2d(c, c, 3, stride=feature_stride, padding=1,
                                       compute_dtype=dtype)
        self.last_lay = DownsampleStage(c, dtype)
        self.model = PlainHead(num_keypoints, num_layers, c, dtype)
        head_init_(self)

    def forward(self, feature: torch.Tensor, heatmap: torch.Tensor) -> torch.Tensor:
        x = self.heatmap_conv(heatmap) + self.feature_conv(feature)
        return self.model(self.last_lay(x))
