"""Serving entry and validation loop.

Port of ``dahpe_tpu/evaluate.py``: ``make_predict_fn`` (images → keypoint
coordinates), ``make_eval_step`` (forward + KL loss + PCK) and ``validate``
(per-group PCK over a device-resident eval split or a host loader). Eval
and serving run the feature extractor and the main head only: under
``jax.jit`` the adversarial heads were dead code, and eager PyTorch would
otherwise run them.

Both factories take a ``device`` (default ``cuda``, see
:func:`dahpe_tpu_torch.default_device`), move the model there, and set the
float32 policy (:func:`dahpe_tpu_torch.set_float32_policy`): no TF32 on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device, set_float32_policy
from dahpe_tpu_torch.core.decode import get_max_preds
from dahpe_tpu_torch.core.losses import joints_kl_loss
from dahpe_tpu_torch.core.metrics import pck_accuracy
from dahpe_tpu_torch.data.device_aug import IMAGENET_MEAN, IMAGENET_STD
from dahpe_tpu_torch.data.pipeline import finalize_batch
from dahpe_tpu_torch.utils.meters import AverageMeter, AverageMeterDict


def _eval_forward(model, images: torch.Tensor) -> torch.Tensor:
    """Eval-mode main-head heatmaps ``(B, h, w, K)``; restores the mode."""
    was_training = model.training
    model.eval()
    try:
        if hasattr(model, "main_head"):
            return model.main_head(model.features(images))
        return model(images)
    finally:
        model.train(was_training)


def _place(model, device) -> torch.device:
    """Move ``model`` to ``device`` (default ``cuda``) and set the float32
    policy; returns the resolved device."""
    device = resolve_device(device)
    model.to(device)
    set_float32_policy()
    return device


def make_eval_step(model, *, device=None):
    """``eval_step(batch) -> dict`` with ``loss_per_sample (B,)``,
    ``acc_per_joint (K,)``, ``avg_acc``, ``cnt`` and ``pred (B, K, 2)``.

    The model is moved to ``device`` (default ``cuda``). ``batch`` holds
    ``image (B, H, W, 3)``, ``target (B, h, w, K)`` and ``weight (B, K)`` on
    that device.
    """
    _place(model, device)

    @torch.inference_mode()
    def eval_step(batch):
        y = _eval_forward(model, batch["image"])
        # per-sample loss (mean over joints) so the caller can leave padded
        # trailing-batch rows out of the reported average
        loss_per_sample = torch.mean(
            joints_kl_loss(y, batch["target"], batch["weight"], reduction="none"),
            dim=1,
        )
        acc_per_joint, avg_acc, cnt, pred = pck_accuracy(y, batch["target"])
        return {
            "loss_per_sample": loss_per_sample,
            "acc_per_joint": acc_per_joint,
            "avg_acc": avg_acc,
            "cnt": cnt,
            "pred": pred,
        }

    return eval_step


def make_predict_fn(model, *, image_size: int = 256, heatmap_size: int = 64,
                    uint8_input: bool = False, device=None):
    """Serving entry: ``predict(images (B, H, W, 3)) -> (coords (B, K, 2),
    maxvals (B, K, 1))`` with coordinates in IMAGE pixels (heatmap argmax
    scaled by the stride, the reference's deployment decode).

    The model is moved to ``device`` (default ``cuda``). ``images`` may be a
    tensor or a numpy array; it is moved to that device. ``uint8_input=True``
    takes raw uint8 HWC frames and applies the ImageNet normalization on the
    device.
    """
    device = _place(model, device)
    scale = image_size / heatmap_size
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    @torch.inference_mode()
    def predict(images):
        images = torch.as_tensor(images, device=device)
        if uint8_input:
            images = images.to(torch.float32) / 255.0
            images = (images - mean) / std
        preds, maxvals = get_max_preds(_eval_forward(model, images))
        return preds * scale, maxvals

    return predict


def validate(
    loader,
    model,
    dataset,
    *,
    image_size: int = 256,
    heatmap_size: int = 64,
    print_freq: int = 100,
    eval_step=None,
    device=None,
) -> dict:
    """Per-group PCK dict (``dataset.keypoints_group`` keys) over ``loader``.

    ``loader`` yields either device-finalized batches
    (:meth:`DeviceDataStore.eval_loader`) on ``device`` (default ``cuda``),
    or host batches (``BatchLoader``: numpy ``image``, ``keypoint2d``,
    ``visible``) that are finalized there with ``image_size`` /
    ``heatmap_size`` targets. A trailing partial host batch is padded to the
    loader's batch size with zero rows: their all-zero targets fail the PCK
    peak filter and the loss is averaged over the real rows only.
    """
    eval_step = eval_step or make_eval_step(model, device=device)
    acc = AverageMeterDict(dataset.keypoints_group.keys(), ":3.2f")
    losses = AverageMeter("Loss", ":.2e")
    full_batch = getattr(loader, "batch_size", None)
    prepared = getattr(loader, "device_finalized", False)

    for i, item in enumerate(loader):
        if prepared:
            batch, n_real = item["batch"], item["n_real"]
        else:
            n_real = int(item["image"].shape[0])
            if full_batch is not None and n_real < full_batch:
                pad = full_batch - n_real
                item = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                        for k, v in item.items()}
            batch = finalize_batch(item, heatmap_size=(heatmap_size, heatmap_size),
                                   image_size=(image_size, image_size), device=device)
        out = eval_step(batch)
        # one device→host copy for both metrics
        rows = out["loss_per_sample"].shape[0]
        fetched = torch.cat([out["loss_per_sample"], out["acc_per_joint"]]).cpu().numpy()
        loss_rows, acc_per_joint = fetched[:n_real], fetched[rows:]
        losses.update(float(loss_rows.mean()), n_real)
        # numpy float32 scalars, as the JAX package hands them to the dataset
        acc.update(dataset.group_accuracy(list(acc_per_joint)), n_real)
        if i % print_freq == 0:
            print(f"Test: [{i}/{len(loader)}]\t{losses}\tall {acc['all'].avg:.3f}")
    return acc.average()
