"""Simple-Baseline deconvolution upsampling (stride-32 → stride-4 features).

Port of ``dahpe_tpu/models/upsampling.py`` (the reference's
``uda/model/pose_resnet2.py:11-56``): three
[ConvTranspose2d(k, s=2) → BN → ReLU] stages, ``(B, 2048, 8, 8)`` to
``(B, 256, 64, 64)``. The deconv is torch's own; the weight keeps torch's
``(I, O, kh, kw)`` layout, which the JAX package stores flipped as HWIO.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d


def deconv_geometry(kernel_size: int) -> tuple[int, int]:
    """``(padding, output_padding)`` that doubles the size for k ∈ {2, 3, 4}."""
    if kernel_size == 4:
        return 1, 0
    if kernel_size == 3:
        return 1, 1
    if kernel_size == 2:
        return 0, 0
    raise NotImplementedError(f"kernel_size {kernel_size}")


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """Stride-2 ``nn.ConvTranspose2d`` with the reference's geometry for k."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 bias: bool = False):
        padding, output_padding = deconv_geometry(kernel_size)
        super().__init__(in_channels, out_channels, kernel_size, stride=2,
                         padding=padding, output_padding=output_padding, bias=bias)


class Upsampling(nn.Sequential):
    """3-stage deconv upsampler; torch keys ``upsampling.{0,3,6}.weight``
    (deconvs) and ``{1,4,7}`` (BNs)."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int] = (256, 256, 256),
                 kernel_sizes: Sequence[int] = (4, 4, 4), bias: bool = False):
        layers = []
        for dim, k in zip(hidden_dims, kernel_sizes):
            layers += [ConvTranspose2dTorch(in_channels, dim, k, bias=bias),
                       BatchNorm2d(dim), nn.ReLU(inplace=True)]
            in_channels = dim
        super().__init__(*layers)
