"""Heatmap → keypoint decoding and heatmap resizing.

Port of ``dahpe_tpu/core/decode.py``: ``get_max_preds`` (the reference's
numpy ``utils/keypoint_detection.py:7-35``), the soft-argmax decode
(``compute_uv_from_heatmaps3``, ``:209-239``), the upsample-then-argmax
decode (``compute_uv_from_heatmaps{,2}``, ``:155-205``) and
``upsample_bilinear``. Heatmaps are ``(B, H, W, K)``.
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


def soft_argmax_decode(heatmaps: torch.Tensor, *, temperature: float = 100.0,
                       scale: float = 4.0) -> torch.Tensor:
    """Differentiable soft-argmax decode, ``(B, H, W, K)`` → ``(B, K, 2)``
    ``(x, y)``: the softmax of ``temperature · heatmap`` over all pixels,
    the expectation of the pixel grid, times ``scale`` (image pixels)."""
    b, h, w, k = heatmaps.shape
    p = torch.softmax(heatmaps.reshape(b, h * w, k) * temperature, dim=1).reshape(b, h, w, k)
    ys = torch.arange(h, dtype=heatmaps.dtype, device=heatmaps.device)[None, :, None, None]
    xs = torch.arange(w, dtype=heatmaps.dtype, device=heatmaps.device)[None, None, :, None]
    ey = torch.sum(p * ys, dim=(1, 2))  # (B, K)
    ex = torch.sum(p * xs, dim=(1, 2))
    return torch.stack([ex, ey], dim=-1) * scale


def decode_uv_from_heatmaps(heatmaps: torch.Tensor, resize_dim: tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample to ``resize_dim``, then the argmax decode:
    ``(B, H, W, K)`` → ``(B, K, 2)`` in ``resize_dim`` pixels."""
    preds, _ = get_max_preds(upsample_bilinear(heatmaps, resize_dim))
    return preds


def upsample_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``(B, H, W, K)`` with ``align_corners=False``:
    source coordinate ``(i + 0.5) * H_in / H_out - 0.5``, clamped at the
    edges (the reference's ``nn.Upsample(mode='bilinear')``), in the input's
    dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)
