"""Simple-Baseline deconvolution upsampling (stride-32 → stride-4 features).

Port of ``dahpe_tpu/models/upsampling.py`` (the reference's
``uda/model/pose_resnet2.py:11-56``): three
[ConvTranspose2d(k, s=2) → BN → ReLU] stages, ``(B, 2048, 8, 8)`` to
``(B, 256, 64, 64)``. The deconv is torch's own; the weight keeps torch's
``(I, O, kh, kw)`` layout, which the JAX package stores flipped as HWIO.
The deconvs start from the JAX package's ``head_init``, N(0, 1e-3²).
``dtype`` is the compute dtype, as in :mod:`dahpe_tpu_torch.models.resnet`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d, bn_relu_sequence
from dahpe_tpu_torch.models.heads import head_init_


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
    """Stride-2 ``nn.ConvTranspose2d`` with the reference's geometry for k;
    input, weight and bias are cast to ``compute_dtype`` (the JAX package's
    ``x.astype(dtype)``, ``kernel.astype(dtype)``), or to the weight's dtype
    where it is ``None``, a cast that changes nothing."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 bias: bool = False, compute_dtype: torch.dtype | None = None):
        padding, output_padding = deconv_geometry(kernel_size)
        super().__init__(in_channels, out_channels, kernel_size, stride=2,
                         padding=padding, output_padding=output_padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Upsampling(nn.Sequential):
    """3-stage deconv upsampler; torch keys ``upsampling.{0,3,6}.weight``
    (deconvs) and ``{1,4,7}`` (BNs)."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int] = (256, 256, 256),
                 kernel_sizes: Sequence[int] = (4, 4, 4), bias: bool = False,
                 dtype: torch.dtype | None = None):
        layers = []
        for dim, k in zip(hidden_dims, kernel_sizes):
            layers += [ConvTranspose2dTorch(in_channels, dim, k, bias=bias,
                                            compute_dtype=dtype),
                       BatchNorm2d(dim), nn.ReLU(inplace=True)]
            in_channels = dim
        super().__init__(*layers)
        head_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_relu_sequence(self, x)
