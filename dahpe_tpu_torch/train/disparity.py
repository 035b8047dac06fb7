"""Regression-disparity losses of the multiscale adversarial cascade.

Port of ``dahpe_tpu/train/disparity.py`` (the reference's
``RegressionDisparityx6`` / ``x5`` / ``x1``, ``regda_7.py:3564-3632,
3485-3561, 3206-3268``). ``mode`` is 'min' (train toward the pseudo ground
truth) or 'max' (toward the ground-false mask).

Labels are built on the device from the main head's detached peaks:

- 'min' labels are the GT Gaussians alone, from the ``render_gaussian``
  kernel (:mod:`dahpe_tpu_torch.ops.gaussian`);
- 'max' labels come from the fused pseudo-label kernel
  (:mod:`dahpe_tpu_torch.ops.pseudo_label`), which builds GT and GF, the
  optional fusion and the max-normalize in one launch.

On the CPU both are their plain PyTorch versions. ``peaks`` may be passed
when the caller decoded the heatmap already: the training step decodes each
main-head heatmap once for all of its losses, on the device.
"""

from __future__ import annotations

import torch

from dahpe_tpu_torch.core.heatmap import (
    gaussian_window_reach,
    peaks_from_heatmap,
    pseudo_label_gt,
)
from dahpe_tpu_torch.core.losses import joints_kl_loss
from dahpe_tpu_torch.ops import pseudo_label

EPS = 1e-7  # the reference uses JointsKLLoss(epsilon=1e-7) for all three


def _peaks(y: torch.Tensor, peaks: torch.Tensor | None) -> torch.Tensor:
    return peaks_from_heatmap(y.detach()) if peaks is None else peaks


def rd_plain(
    y: torch.Tensor,
    y_adv: torch.Tensor,
    weight: torch.Tensor | None,
    mode: str,
    *,
    epsilon: float = EPS,
    peaks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Original RegDA disparity (``regda_4.py:89-143``): GT from the peak
    Gaussian, GF = clipped union of the OTHER joints' Gaussians."""
    target = _target(y, peaks, scale=1, window_factor=3.0, gf_kind="union_others",
                     fused_target=None, normalize=False, mode=mode)
    return joints_kl_loss(y_adv, target, weight, epsilon=epsilon)


def _target(
    y: torch.Tensor,
    peaks: torch.Tensor | None,
    *,
    scale: int,
    window_factor: float,
    gf_kind: str,
    fused_target: torch.Tensor | None,
    normalize: bool,
    mode: str,
) -> torch.Tensor:
    """The label a disparity loss trains toward: GT for 'min', GF for 'max'."""
    peaks = _peaks(y, peaks)
    if mode == "min":
        return pseudo_label_gt(y.detach(), scale=scale, window_factor=window_factor,
                               peaks=peaks)
    _, gf = pseudo_label.pseudo_labels(
        peaks // scale, None if fused_target is None else fused_target.detach(),
        out_size=y.shape[-3] // scale, reach=gaussian_window_reach(2.0, window_factor),
        gf_kind=gf_kind, normalize=normalize, with_gt=False,
    )
    return gf


def rd_64(
    y: torch.Tensor,
    y_adv: torch.Tensor,
    fused_target: torch.Tensor | None,
    weight: torch.Tensor | None,
    mode: str,
    *,
    peaks: torch.Tensor | None = None,
) -> torch.Tensor:
    """64x64 disparity (``RegressionDisparityx6``, ``regda_7.py:3609-3632``):
    GF = clip(clip(sum_k GT) - 10 GT) [+ fused target, -100 GT], then
    per-(sample, joint) max-normalized."""
    target = _target(y, peaks, scale=1, window_factor=3.0, gf_kind="union_minus",
                     fused_target=fused_target, normalize=True, mode=mode)
    return joints_kl_loss(y_adv, target, weight, epsilon=EPS)


def rd_32(
    y: torch.Tensor,
    y_adv2: torch.Tensor,
    fused_target: torch.Tensor | None,
    weight: torch.Tensor | None,
    mode: str,
    *,
    peaks: torch.Tensor | None = None,
) -> torch.Tensor:
    """32x32 disparity (``RegressionDisparityx5``, ``regda_7.py:3530-3561``):
    peaks from the 64x64 main heatmap, halved; GF = clip(1 - 10 GT)
    [+ fused target, -100 GT], max-normalized."""
    target = _target(y, peaks, scale=2, window_factor=2.0, gf_kind="inverse",
                     fused_target=fused_target, normalize=True, mode=mode)
    return joints_kl_loss(y_adv2, target, weight, epsilon=EPS)


def rd_16(
    y: torch.Tensor,
    y_adv3: torch.Tensor,
    weight: torch.Tensor | None,
    mode: str,
    *,
    peaks: torch.Tensor | None = None,
) -> torch.Tensor:
    """16x16 disparity (``RegressionDisparityx1``, ``regda_7.py:3251-3268``):
    peaks from the 64x64 main heatmap, quartered; GF = clip(1 - 10 GT), no
    fusion and no max-normalization at this scale."""
    target = _target(y, peaks, scale=4, window_factor=1.5, gf_kind="inverse",
                     fused_target=None, normalize=False, mode=mode)
    return joints_kl_loss(y_adv3, target, weight, epsilon=EPS)
