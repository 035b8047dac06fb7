"""The original RegDA baseline model: three same-scale heads, no fusion
cascade.

Port of ``dahpe_tpu/models/regda_baseline.py`` (the reference's
``uda/model/regda_4.py:PoseResNet``, ``:649-742``, the CVPR'21 RegDA
architecture the multiscale model grew from): the main head ``y``, the
adversarial head ``y_adv`` behind the gradient-scale (GL) layer, and a
second adversarial head ``y_adv2`` off the clean features. Every output is
returned in training and in eval; eval consumers read ``y_adv2``
(``regda_4.py:716-727``). Layouts and ``dtype`` are
:class:`~dahpe_tpu_torch.models.pose_resnet.MultiHeadPoseResNet`'s.
"""

from __future__ import annotations

import torch
from torch import nn

from dahpe_tpu_torch.core.layout import from_bkhw, to_bkhw
from dahpe_tpu_torch.models.heads import PlainHead
from dahpe_tpu_torch.models.upsampling import Upsampling
from dahpe_tpu_torch.ops.gradient_scale import gradient_scale


class RegDAPoseResNet(nn.Module):
    def __init__(self, backbone: nn.Module, num_keypoints: int = 21, feature_dim: int = 256,
                 num_head_layers: int = 2, dtype: torch.dtype | None = None):
        super().__init__()
        common = dict(num_keypoints=num_keypoints, num_layers=num_head_layers,
                      channel_dim=feature_dim, dtype=dtype)
        self.backbone = backbone
        self.upsampling = Upsampling(backbone.out_features, (feature_dim,) * 3, dtype=dtype)
        self.head = PlainHead(**common)
        self.head_adv = PlainHead(**common)
        self.head_adv2 = PlainHead(**common)

    def forward(self, x: torch.Tensor, gl_coeff=0.0) -> dict[str, torch.Tensor]:
        """``(B, H, W, 3)`` → ``{"y", "y_adv", "y_adv2", "f"}``, NHWC."""
        f = self.upsampling(self.backbone(to_bkhw(x)))
        return {"y": from_bkhw(self.head(f)),
                "y_adv": from_bkhw(self.head_adv(gradient_scale(f, gl_coeff))),
                "y_adv2": from_bkhw(self.head_adv2(f)), "f": from_bkhw(f)}
