"""Gaussian heatmap targets and peak extraction.

Port of ``dahpe_tpu/core/heatmap.py`` (the serving/validation half). A
target heatmap for a peak ``(mu_x, mu_y)`` is

    g[y, x] = exp(-((x - mu_x)^2 + (y - mu_y)^2) / (2 sigma^2))
              if |x - mu_x| <= reach and |y - mu_y| <= reach else 0

rendered by the CUDA kernel on the card (:mod:`dahpe_tpu_torch.ops.gaussian`)
and by its plain PyTorch twin on the CPU. Heatmaps are ``(..., H, W, K)``.
"""

from __future__ import annotations

import torch

from dahpe_tpu_torch.ops import gaussian


def gaussian_window_reach(sigma: float, window_factor: float) -> int:
    """Integer truncation reach of the reference's windowed Gaussian:
    ``int(sigma * window_factor)`` (reach 6 at 64², 4 at 32², 3 at 16²)."""
    return int(sigma * window_factor)


def render_gaussian(
    mu: torch.Tensor,
    height: int,
    width: int,
    *,
    sigma: float = 2.0,
    reach: int = 6,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Render unnormalized (peak=1) windowed Gaussians at integer peaks.

    Args:
      mu: ``(..., K, 2)`` integer peak coordinates as ``(x, y)``.
      height, width: heatmap size.
      valid: optional ``(..., K)`` mask; joints where it is zero/False render
        as all-zero maps.

    Returns:
      ``(..., H, W, K)`` float32 heatmaps.
    """
    *lead, k, _ = mu.shape
    mu = mu.reshape(-1, k, 2)
    if valid is None:
        valid = torch.ones(mu.shape[:2], dtype=torch.float32, device=mu.device)
    else:
        valid = valid.reshape(-1, k).to(torch.float32)
    out = gaussian.render_gaussian(
        mu, valid, height=height, width=width, sigma=sigma, reach=reach
    )
    return out.reshape(*lead, height, width, k)


def generate_target(
    keypoints: torch.Tensor,
    visible: torch.Tensor,
    heatmap_size: tuple[int, int],
    image_size: tuple[int, int],
    *,
    sigma: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Gaussian targets, as the reference's ``generate_target``.

    Peak at ``trunc(kp / stride + 0.5)``, window reach ``int(3 * sigma)``; a
    joint whose peak falls outside the map or whose visibility is 0 gets
    weight 0 and an all-zero map.

    Args:
      keypoints: ``(..., K, 2)`` float image-space ``(x, y)``.
      visible:   ``(..., K)`` visibility in {0, 1}.
      heatmap_size: ``(W_hm, H_hm)``.
      image_size:   ``(W_img, H_img)``.

    Returns:
      target ``(..., H_hm, W_hm, K)``, weight ``(..., K)``.
    """
    hm_w, hm_h = heatmap_size
    img_w, img_h = image_size
    stride_x = img_w / hm_w
    stride_y = img_h / hm_h
    mu_x = torch.trunc(keypoints[..., 0] / stride_x + 0.5).to(torch.int32)
    mu_y = torch.trunc(keypoints[..., 1] / stride_y + 0.5).to(torch.int32)
    in_bounds = (mu_x >= 0) & (mu_x < hm_w) & (mu_y >= 0) & (mu_y < hm_h)
    weight = visible.to(torch.float32) * in_bounds.to(torch.float32)
    mu = torch.stack([mu_x, mu_y], dim=-1)
    reach = gaussian_window_reach(sigma, 3.0)
    target = render_gaussian(
        mu, hm_h, hm_w, sigma=sigma, reach=reach, valid=weight > 0.5
    )
    return target, weight


def peaks_from_heatmap(y: torch.Tensor) -> torch.Tensor:
    """Flat-argmax peaks of ``(..., H, W, K)`` heatmaps → ``(..., K, 2)`` int32.

    First maximum wins; peaks with a maximum <= 0 go to the origin.
    """
    *lead, h, w, k = y.shape
    flat = y.reshape(*lead, h * w, k)
    maxv = flat.amax(dim=-2)
    idx = flat.argmax(dim=-2)  # first occurrence
    keep = maxv > 0.0
    px = torch.where(keep, idx % w, 0).to(torch.int32)
    py = torch.where(keep, idx // w, 0).to(torch.int32)
    return torch.stack([px, py], dim=-1)
