"""Layout converters between the public NHWC layout and torch's NCHW.

The port keeps ``dahpe_tpu``'s public layouts: images ``(B, H, W, C)`` and
heatmaps ``(B, H, W, K)``. Convolutions run NCHW. Both converters return
views: the NCHW view of a contiguous NHWC tensor is a ``channels_last``
tensor, and converting back restores the original strides, so crossing the
boundary copies nothing.
"""

from __future__ import annotations

import torch


def to_bkhw(x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, K)`` → ``(B, K, H, W)`` (torch layout), as a view."""
    return x.permute(0, 3, 1, 2)


def from_bkhw(x: torch.Tensor) -> torch.Tensor:
    """``(B, K, H, W)`` (torch layout) → ``(B, H, W, K)``, as a view."""
    return x.permute(0, 2, 3, 1)

