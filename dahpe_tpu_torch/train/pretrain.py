"""Supervised source-only pretraining step (Simple Baseline).

Port of ``dahpe_tpu/train/pretrain.py`` (reference: ``train1.py:278-325``):
KL loss on source heatmaps, SGD (momentum 0.9, Nesterov, wd 1e-4) over three
parameter groups with the backbone at 0.1x lr (``get_parameters``,
``pose_resnet2.py:184-189``) and MultiStepLR([45, 60], 0.1) stepped before
each epoch (``optim.pretrain_lr_factor``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device, set_float32_policy
from dahpe_tpu_torch.core.losses import joints_kl_loss
from dahpe_tpu_torch.core.metrics import pck_accuracy
from dahpe_tpu_torch.train.optim import make_partitioned_sgd, step_partitions, zero_grad

PRETRAIN_PARTITIONS = {
    "backbone": ("backbone",),
    "upsampling": ("upsampling",),
    "head": ("head",),
}

# finetune=True at train1.py:162 → backbone gets 10x smaller lr
PRETRAIN_LR_SCALES = {"backbone": 0.1, "upsampling": 1.0, "head": 1.0}


@dataclass
class PretrainState:
    """The model, one SGD per partition and the host step count."""

    model: torch.nn.Module
    optimizers: dict[str, torch.optim.SGD]
    step: int = 0


def create_pretrain_state(model: torch.nn.Module, *, device=None, momentum: float = 0.9,
                          weight_decay: float = 1e-4) -> PretrainState:
    """Training state around ``model`` (a ``PoseResNet``, moved to ``device``,
    default the card) with fresh momentum and step 0. Sets the port's
    float32 policy (no TF32)."""
    set_float32_policy()
    model.to(resolve_device(device)).train()
    return PretrainState(model, make_partitioned_sgd(
        model, PRETRAIN_PARTITIONS, momentum=momentum, weight_decay=weight_decay))


def make_pretrain_step(
    model: torch.nn.Module,
    *,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    compute_metrics: bool = True,
) -> Callable:
    """``(state, batch, lr) -> (state, metrics)``; ``lr`` is the epoch-level
    MultiStepLR value (``base_lr * pretrain_lr_factor(epoch)``), a host float."""
    hyper = dict(momentum=momentum, weight_decay=weight_decay)

    def pretrain_step(state: PretrainState, batch: dict, lr: float):
        x, label, w = batch["image"], batch["target"], batch["weight"]
        model.train()
        zero_grad(state.optimizers, tuple(PRETRAIN_PARTITIONS))
        y = model(x)
        loss = joints_kl_loss(y, label, w)
        loss.backward()
        for name in PRETRAIN_PARTITIONS:
            # float32 product, as the JAX package scales its float32 lr
            scaled = float(np.float32(lr) * np.float32(PRETRAIN_LR_SCALES[name]))
            step_partitions(state.optimizers, (name,), scaled, **hyper)
        metrics = {"loss_s": loss.detach(), "lr": float(lr)}
        if compute_metrics:
            with torch.no_grad():
                metrics["acc_s"] = pck_accuracy(y.detach(), label)[1]
        state.step += 1
        return state, metrics

    return pretrain_step

