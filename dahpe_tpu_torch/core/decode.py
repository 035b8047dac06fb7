"""Heatmap → keypoint decoding and heatmap resizing.

Port of ``dahpe_tpu/core/decode.py``: ``get_max_preds`` (the reference's
numpy ``utils/keypoint_detection.py:7-35``) and ``upsample_bilinear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def get_max_preds(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax decode of ``(B, H, W, K)`` heatmaps.

    Returns ``preds (B, K, 2)`` float ``(x, y)`` and ``maxvals (B, K, 1)``.
    The first maximum wins, and predictions whose max value is <= 0 are
    zeroed.
    """
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k)
    idx = torch.argmax(flat, dim=1)  # (B, K), first occurrence
    maxvals = torch.amax(flat, dim=1)  # (B, K)
    px = (idx % w).to(torch.float32)
    py = torch.floor(idx.to(torch.float32) / w)
    preds = torch.stack([px, py], dim=-1)  # (B, K, 2)
    mask = (maxvals > 0.0).to(torch.float32)[..., None]
    return preds * mask, maxvals[..., None]


def upsample_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``(B, H, W, K)`` with ``align_corners=False``:
    source coordinate ``(i + 0.5) * H_in / H_out - 0.5``, clamped at the
    edges (the reference's ``nn.Upsample(mode='bilinear')``), in the input's
    dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)
