"""PCK evaluation on the device.

Port of ``dahpe_tpu/core/metrics.py`` (``calc_dists`` / ``dist_acc`` /
``pck_accuracy`` / ``group_accuracy``; the reference's
``utils/keypoint_detection.py:38-92``).
"""

from __future__ import annotations

import torch

from dahpe_tpu_torch.core.decode import get_max_preds


def calc_dists(
    preds: torch.Tensor, target: torch.Tensor, normalize: torch.Tensor
) -> torch.Tensor:
    """Normalized distances, invalid entries marked -1.

    A joint counts only when BOTH target coords are > 1 (heatmap pixels).

    Args: preds/target ``(B, K, 2)``; normalize ``(B, 2)``.
    Returns: ``(K, B)`` distances (reference orientation).
    """
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)  # (B, K)
    diff = (preds - target) / normalize[:, None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))  # (B, K)
    d = torch.where(valid, d, torch.full_like(d, -1.0))
    return d.T


def dist_acc(dists: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Fraction below threshold among valid (-1-free) entries, else -1.

    ``dists``: ``(K, B)``. Returns ``(K,)`` float32.
    """
    valid = dists != -1.0
    n = torch.sum(valid, dim=-1)
    hits = torch.sum((dists < thr) & valid, dim=-1)
    frac = hits.to(torch.float32) / n.clamp(min=1).to(torch.float32)
    return torch.where(n > 0, frac, torch.full_like(frac, -1.0))


def pck_accuracy(
    output: torch.Tensor, target: torch.Tensor, *, thr: float = 0.5
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCK from heatmaps (both ``(B, H, W, K)``), per the reference metric.

    Normalization is ``heatmap_size / 10`` so ``thr=0.5`` is PCK@0.05 of the
    heatmap. Returns ``(acc (K,), avg_acc (), cnt (), preds (B, K, 2))``;
    ``acc`` is -1 for joints with no valid sample and ``avg_acc`` averages
    only over valid joints.

    Bfloat16 heatmaps decode as float32 ones do (a first-occurrence argmax,
    float32 coordinates); as in the JAX package the normalizer is made in
    the heatmaps' dtype (``h / 10`` rounded to bfloat16) and the distances
    in float32.
    """
    pred, _ = get_max_preds(output)
    acc, avg, cnt = pck_of_preds(pred, target, thr=thr, norm_dtype=output.dtype)
    return acc, avg, cnt, pred


def pck_of_preds(
    pred: torch.Tensor, target: torch.Tensor, *, thr: float = 0.5, norm_dtype=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pck_accuracy` of decoded predictions ``pred (B, K, 2)`` in
    heatmap pixels against ``(B, H, W, K)`` target heatmaps: ``(acc (K,),
    avg_acc (), cnt ())``. The normalizer ``heatmap_size / 10`` is made in
    ``norm_dtype`` (default ``pred``'s); the distances are in ``pred``'s."""
    b, h, w, _ = target.shape
    gt, _ = get_max_preds(target)
    # filled on the device: a tensor built from a host list is a copy that
    # waits for the stream
    dt = norm_dtype or pred.dtype
    norm = torch.stack([torch.full((b,), h / 10.0, dtype=dt, device=pred.device),
                        torch.full((b,), w / 10.0, dtype=dt, device=pred.device)],
                       dim=-1)
    dists = calc_dists(pred, gt, norm)
    acc = dist_acc(dists, thr)
    valid = acc >= 0
    cnt = torch.sum(valid)
    total = torch.sum(torch.where(valid, acc, torch.zeros_like(acc)))
    avg = torch.where(
        cnt > 0, total / cnt.clamp(min=1).to(acc.dtype), torch.zeros_like(total)
    )
    return acc, avg, cnt


def group_accuracy(
    acc_per_joint: torch.Tensor, groups: dict[str, list[int]]
) -> dict[str, torch.Tensor]:
    """Average per-joint PCK over named joint groups; joints reporting -1 are
    skipped and a group with no valid joint reports -1."""
    out = {}
    for name, idxs in groups.items():
        vals = acc_per_joint[torch.as_tensor(idxs, device=acc_per_joint.device)]
        valid = vals >= 0
        n = torch.sum(valid)
        total = torch.sum(torch.where(valid, vals, torch.zeros_like(vals)))
        out[name] = torch.where(
            n > 0, total / n.clamp(min=1).to(vals.dtype), torch.full_like(total, -1.0)
        )
    return out
