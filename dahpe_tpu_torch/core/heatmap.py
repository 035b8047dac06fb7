"""Gaussian heatmap targets, peak extraction and pseudo-labels.

Port of ``dahpe_tpu/core/heatmap.py``: targets, peaks and the pseudo-label
(GT / ground-false) functions of the disparity losses. A target heatmap for a
peak ``(mu_x, mu_y)`` is

    g[y, x] = exp(-((x - mu_x)^2 + (y - mu_y)^2) / (2 sigma^2))
              if |x - mu_x| <= reach and |y - mu_y| <= reach else 0

rendered by the CUDA kernel on the card (:mod:`dahpe_tpu_torch.ops.gaussian`)
and by its plain PyTorch twin on the CPU. Heatmaps are ``(..., H, W, K)``.

The GF functions below are the plain versions the fused pseudo-label kernel
(:mod:`dahpe_tpu_torch.ops.pseudo_label`) is held against.
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
      valid: optional ``(..., K)`` mask. A boolean mask renders the joints
        where it is False as all-zero maps (the kernel's own mask); any other
        dtype multiplies the maps, as the JAX function does for every mask.

    Returns:
      ``(..., H, W, K)`` float32 heatmaps.
    """
    *lead, k, _ = mu.shape
    mu = mu.reshape(-1, k, 2)
    if valid is not None and valid.dtype == torch.bool:
        mask, factor = valid.reshape(-1, k).to(torch.float32), None
    else:
        mask, factor = torch.ones(mu.shape[:2], dtype=torch.float32, device=mu.device), valid
    out = gaussian.render_gaussian(
        mu, mask, height=height, width=width, sigma=sigma, reach=reach
    ).reshape(*lead, height, width, k)
    if factor is not None:
        out = out * factor.to(torch.float32)[..., None, None, :]
    return out


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


def pseudo_label_gt(
    y: torch.Tensor,
    *,
    scale: int = 1,
    out_size: int | None = None,
    sigma: float = 2.0,
    window_factor: float = 3.0,
    peaks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ground-truth pseudo heatmaps from a predicted heatmap.

    Argmax-decode ``y (..., H, W, K)``, integer-divide the peaks by ``scale``
    (1 / 2 / 4 for the 64 / 32 / 16 heads) and render the windowed Gaussian
    at ``out_size``. ``peaks`` may be passed when the caller already decoded
    ``y``. Gradients are not stopped here: callers pass ``y.detach()``.
    """
    *_, h, _, _ = y.shape
    if out_size is None:
        out_size = h // scale
    if peaks is None:
        peaks = peaks_from_heatmap(y)
    reach = gaussian_window_reach(sigma, window_factor)
    return render_gaussian(peaks // scale, out_size, out_size, sigma=sigma, reach=reach)


def gf_union_others(gt: torch.Tensor) -> torch.Tensor:
    """GF = clip(sum of the OTHER joints' Gaussians): ``(..., H, W, K)``."""
    total = torch.sum(gt, dim=-1, keepdim=True)
    return torch.clamp(total - gt, 0.0, 1.0)


def gf_inverse(gt: torch.Tensor) -> torch.Tensor:
    """GF = clip(1 - 10 * GT)."""
    return torch.clamp(1.0 - gt * 10.0, 0.0, 1.0)


def gf_union_minus(gt: torch.Tensor) -> torch.Tensor:
    """GF = clip(clip(sum_k GT) - 10 * GT)."""
    label_p = torch.clamp(torch.sum(gt, dim=-1, keepdim=True), 0.0, 1.0)
    return torch.clamp(label_p - gt * 10.0, 0.0, 1.0)


def fuse_and_normalize_gf(
    gf: torch.Tensor, gt: torch.Tensor, fused_target: torch.Tensor | None
) -> torch.Tensor:
    """Optionally fuse a coarser head's heatmap into GF, then max-normalize.

    With a fused target ``GF = clip(GF + target - 100 * GT)``; then every
    (sample, joint) map is divided by its max, guarded by 1e-12 so an
    all-zero map stays zero where the reference's division gives NaN.
    """
    if fused_target is not None:
        gf = torch.clamp(gf + fused_target - gt * 100.0, 0.0, 1.0)
    m = torch.amax(gf, dim=(-3, -2), keepdim=True)
    return gf / torch.clamp(m, min=1e-12)
