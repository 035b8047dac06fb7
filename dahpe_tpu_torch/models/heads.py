"""Regression heads: the plain per-scale head and the two multiscale fusion
heads of the reference's cascade.

Port of ``dahpe_tpu/models/heads.py``. Parity targets in the reference:
plain head ``regda_7.py:4906-4929``, 64→32 fusion ``regda_7.py:4508-4581``,
→16 fusion ``regda_7.py:4583-4662``. Submodules are torch Sequential indices,
so ``.pth`` keys load unchanged (e.g. ``head_adv2.last_lay.2.weight``).
"""

from __future__ import annotations

import torch
from torch import nn

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d


class PlainHead(nn.Sequential):
    """[Conv3x3 → BN → ReLU] x (num_layers-1) → Conv1x1(C→K)."""

    def __init__(self, num_keypoints: int, num_layers: int = 2, channel_dim: int = 256):
        layers = []
        for _ in range(num_layers - 1):
            layers += [nn.Conv2d(channel_dim, channel_dim, 3, padding=1),
                       BatchNorm2d(channel_dim), nn.ReLU(inplace=True)]
        layers.append(nn.Conv2d(channel_dim, num_keypoints, 1))
        super().__init__(*layers)


class DownsampleStage(nn.Sequential):
    """[BN, ReLU, Conv3x3 s2, BN, ReLU, Conv1x1, BN, ReLU]: one stride-2 block
    halving the spatial size (``regda_7.py:4544-4571``)."""

    def __init__(self, channel_dim: int = 256):
        c = channel_dim
        super().__init__(
            BatchNorm2d(c), nn.ReLU(inplace=True),
            nn.Conv2d(c, c, 3, stride=2, padding=1), BatchNorm2d(c), nn.ReLU(inplace=True),
            nn.Conv2d(c, c, 1), BatchNorm2d(c), nn.ReLU(inplace=True),
        )


class FusionHead(nn.Module):
    """Adversarial fusion head: previous heatmap + features → half-res heatmap.

    ``feature_stride=1`` is ``make_head`` (head_adv2: fused at 64, out at 32);
    ``feature_stride=2`` is ``make_head2`` (head_adv3: features 64→32 by a
    strided 3x3, fused at 32, out at 16).
    """

    def __init__(self, num_keypoints: int, feature_stride: int = 1,
                 num_layers: int = 2, channel_dim: int = 256):
        super().__init__()
        c = channel_dim
        self.heatmap_conv = nn.Conv2d(num_keypoints, c, 1)
        if feature_stride == 1:
            self.feature_conv = nn.Conv2d(c, c, 1)
        else:
            self.feature_conv = nn.Conv2d(c, c, 3, stride=feature_stride, padding=1)
        self.last_lay = DownsampleStage(c)
        self.model = PlainHead(num_keypoints, num_layers, c)

    def forward(self, feature: torch.Tensor, heatmap: torch.Tensor) -> torch.Tensor:
        x = self.heatmap_conv(heatmap) + self.feature_conv(feature)
        return self.model(self.last_lay(x))
