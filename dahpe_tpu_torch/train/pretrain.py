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
    """The model, one SGD per partition and the host step count (the
    pretrain step reads no schedule from it)."""

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


def lr_tensor(lr, device) -> torch.Tensor:
    """``lr`` (a host number or a 0-d tensor) as a 0-d float32 tensor on
    ``device``; a host number is written by a fill, not copied, so the host
    does not wait for the device."""
    if isinstance(lr, torch.Tensor):
        return lr.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(np.float32(lr)), dtype=torch.float32, device=device)


def make_pretrain_step(
    model: torch.nn.Module,
    *,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    compute_metrics: bool = True,
) -> Callable:
    """``(state, batch, lr) -> (state, metrics)``; ``lr`` is the epoch-level
    MultiStepLR value (``base_lr * pretrain_lr_factor(epoch)``): a host
    number or a 0-d tensor, used as a float32 tensor on the model's device.
    The metrics are 0-d device tensors.

    The returned function's ``run(state, batch, lr_t) -> metrics`` is the
    step on a device lr tensor without the host step count's advance (what
    ``train/fused.py`` captures)."""
    hyper = dict(momentum=momentum, weight_decay=weight_decay)

    def run(state: PretrainState, batch: dict, lr: torch.Tensor) -> dict:
        x, label, w = batch["image"], batch["target"], batch["weight"]
        model.train()
        zero_grad(state.optimizers, tuple(PRETRAIN_PARTITIONS))
        y = model(x)
        loss = joints_kl_loss(y, label, w)
        loss.backward()
        for name in PRETRAIN_PARTITIONS:
            # a float32 product, as the JAX package scales its float32 lr
            step_partitions(state.optimizers, (name,), lr * PRETRAIN_LR_SCALES[name], **hyper)
        metrics = {"loss_s": loss.detach(), "lr": lr.clone()}
        if compute_metrics:
            with torch.no_grad():
                metrics["acc_s"] = pck_accuracy(y.detach(), label)[1]
        return metrics

    def pretrain_step(state: PretrainState, batch: dict, lr):
        metrics = run(state, batch, lr_tensor(lr, batch["image"].device))
        state.step += 1
        return state, metrics

    pretrain_step.run = run
    return pretrain_step

