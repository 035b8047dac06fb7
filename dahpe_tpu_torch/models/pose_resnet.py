"""Pose estimation models: supervised Simple-Baseline and the multiscale
adversarial multi-head model.

Port of ``dahpe_tpu/models/pose_resnet.py``. Parity targets in the
reference: ``PoseResNet`` ← ``uda/model/pose_resnet2.py:157-189``,
``MultiHeadPoseResNet`` ← ``PoseResNetx9`` / ``PoseResNetx10``
(``uda/model/regda_7.py:4861-5061``).

Public methods take and return the JAX package's layouts: images
``(B, H, W, 3)``, features and heatmaps ``(B, H, W, C)``. Inside, the
convolutions run NCHW; the layout converters are views, so the NHWC input
reaches the first convolution as a ``channels_last`` tensor and nothing is
copied at the boundary.

``dtype`` is the compute dtype (the Flax modules' ``dtype``): with
``torch.bfloat16`` the convolutions and deconvolutions compute in bfloat16
on float32 parameters, batch norm keeps float32 statistics, and every
output is bfloat16; the images stay float32 into the first convolution,
which casts them. ``None`` computes in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from dahpe_tpu_torch.core.layout import from_bkhw, to_bkhw
from dahpe_tpu_torch.models.heads import FusionHead, PlainHead, head_init_
from dahpe_tpu_torch.models.resnet import Conv2d
from dahpe_tpu_torch.models.upsampling import Upsampling
from dahpe_tpu_torch.ops.gradient_scale import gradient_scale


class PoseResNet(nn.Module):
    """Backbone → deconv upsampling → Conv1x1 head (pretrain model)."""

    def __init__(self, backbone: nn.Module, num_keypoints: int = 21,
                 feature_dim: int = 256, dtype: torch.dtype | None = None):
        super().__init__()
        self.backbone = backbone
        self.upsampling = Upsampling(backbone.out_features, (feature_dim,) * 3, dtype=dtype)
        self.head = head_init_(Conv2d(feature_dim, num_keypoints, 1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor, gl_coeff=0.0) -> torch.Tensor:
        del gl_coeff  # uniform signature with MultiHeadPoseResNet
        return from_bkhw(self.head(self.upsampling(self.backbone(to_bkhw(x)))))


class MultiHeadPoseResNet(nn.Module):
    """Main head + 3-scale adversarial cascade (64 → 32 → 16 heatmaps).

    ``forward`` returns all five outputs; eval and serving call
    :meth:`features` then :meth:`main_head` only. Under ``jax.jit`` the
    unread adversarial heads were dead code; eager PyTorch would run them,
    so the split keeps them off those paths with the same numbers.
    """

    def __init__(self, backbone: nn.Module, num_keypoints: int = 21,
                 feature_dim: int = 256, num_head_layers: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        common = dict(num_keypoints=num_keypoints, num_layers=num_head_layers,
                      channel_dim=feature_dim, dtype=dtype)
        self.backbone = backbone
        self.upsampling = Upsampling(backbone.out_features, (feature_dim,) * 3, dtype=dtype)
        self.head = PlainHead(**common)
        self.head_adv = PlainHead(**common)
        self.head_adv2 = FusionHead(feature_stride=1, **common)
        self.head_adv3 = FusionHead(feature_stride=2, **common)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone + deconv upsampling: ``(B, H, W, 3)`` → ``(B, H/4, W/4, 256)``."""
        return from_bkhw(self.upsampling(self.backbone(to_bkhw(x))))

    def main_head(self, f: torch.Tensor) -> torch.Tensor:
        """The supervised 64×64 head on the feature map (NHWC in and out)."""
        return from_bkhw(self.head(to_bkhw(f)))

    def adv_heads(self, f: torch.Tensor, gl_coeff=0.0) -> dict[str, torch.Tensor]:
        """The three adversarial heads off the λ-scaled feature map; λ is
        rounded to the features' dtype (``gradient_scale``), as the JAX
        package's ``jnp.asarray(gl_coeff, dtype=f.dtype)``."""
        f_adv = gradient_scale(to_bkhw(f), gl_coeff)
        y_adv = self.head_adv(f_adv)
        y_adv2 = self.head_adv2(f_adv, y_adv)
        y_adv3 = self.head_adv3(f_adv, y_adv2)
        return {"y_adv": from_bkhw(y_adv), "y_adv2": from_bkhw(y_adv2),
                "y_adv3": from_bkhw(y_adv3)}

    def forward(self, x: torch.Tensor, gl_coeff=0.0) -> dict[str, torch.Tensor]:
        f = self.features(x)
        y = self.main_head(f)
        return {"y": y, "f": f, **self.adv_heads(f, gl_coeff)}
