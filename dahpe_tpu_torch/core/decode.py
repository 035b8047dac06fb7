"""Heatmap → keypoint decoding.

Port of ``dahpe_tpu/core/decode.py:get_max_preds`` (the reference's numpy
``utils/keypoint_detection.py:7-35``).
"""

from __future__ import annotations

import torch


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
