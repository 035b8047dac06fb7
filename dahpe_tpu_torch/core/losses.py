"""Keypoint losses (KL / MSE over flattened heatmaps).

Port of ``dahpe_tpu/core/losses.py`` (the reference's ``uda/model/loss.py``).
"""

from __future__ import annotations

import torch


def _reduce(loss: torch.Tensor, target_weight, reduction: str) -> torch.Tensor:
    b, k = loss.shape
    if target_weight is not None:
        loss = loss * target_weight.reshape(b, k)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def joints_kl_loss(
    output: torch.Tensor,
    target: torch.Tensor,
    target_weight: torch.Tensor | None = None,
    *,
    epsilon: float = 0.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Per-joint KL divergence between heatmap distributions.

    The prediction is log-softmaxed over all pixels, the target is
    ``(target + eps)`` normalized to a distribution, and the elementwise KL
    ``t * (log t - log p)`` (0 at t == 0) is summed over pixels, weighted per
    joint and mean-reduced over (B, K).

    Like the JAX package, the target's sum is guarded with 1e-12 so an
    all-zero (invisible / out-of-bounds) joint contributes exactly 0 instead
    of the reference's NaN. A bfloat16 prediction is log-softmaxed in
    bfloat16 and the KL is float32 against the float32 target, as the JAX
    package's promotions give.

    Args:
      output / target: ``(B, H, W, K)``.
      target_weight: ``(B, K)`` or ``(B, K, 1)`` visibility weights.
    """
    b, h, w, k = output.shape
    logp = torch.log_softmax(output.reshape(b, h * w, k), dim=1)
    t = target.reshape(b, h * w, k) + epsilon
    t = t / torch.clamp(torch.sum(t, dim=1, keepdim=True), min=1e-12)
    kl = torch.xlogy(t, t) - t * logp
    return _reduce(torch.sum(kl, dim=1), target_weight, reduction)


def joints_mse_loss(
    output: torch.Tensor,
    target: torch.Tensor,
    target_weight: torch.Tensor | None = None,
    *,
    reduction: str = "mean",
) -> torch.Tensor:
    """0.5 * MSE over flattened heatmaps, visibility-weighted: per-pixel
    squared error halved, mean over pixels, per-joint weight, mean over
    (B, K)."""
    b, h, w, k = output.shape
    se = 0.5 * (output - target) ** 2
    return _reduce(torch.mean(se.reshape(b, h * w, k), dim=1), target_weight, reduction)
