"""Partitioned SGD and learning-rate schedules with the reference's semantics.

Port of ``dahpe_tpu/train/optim.py``. The reference drives five separate
``torch.optim.SGD`` instances over disjoint parameter partitions, stepped in
different subsets per minimax sub-step (``train1.py:141-154, 392-397,
433-436, 450``). Here they are five ``torch.optim.SGD`` instances again; one
that is not stepped keeps its parameters and momentum frozen, which is what
the JAX package's ``apply_partition_updates`` reproduces with optax. Their
update order is ``torch_sgd``'s: weight decay added to the gradient before
the momentum trace, then the Nesterov lookahead.

Learning rates are plain host floats, pure functions of the step count kept
on the host, so setting them costs no device sync.
"""

from __future__ import annotations

import numpy as np
import torch

# partition name -> top-level module names
DA_PARTITIONS: dict[str, tuple[str, ...]] = {
    "f": ("backbone", "upsampling"),
    "h": ("head",),
    "h_adv": ("head_adv",),
    "h_adv2": ("head_adv2",),
    "h_adv3": ("head_adv3",),
}


def partition_params(model: torch.nn.Module, keys: tuple[str, ...]) -> list[torch.nn.Parameter]:
    """The parameters of the top-level submodules ``keys`` of ``model``."""
    return [p for key in keys for p in getattr(model, key).parameters()]


def make_partitioned_sgd(
    model: torch.nn.Module, partitions: dict[str, tuple[str, ...]], *,
    momentum: float = 0.9, weight_decay: float = 1e-4,
) -> dict[str, torch.optim.SGD]:
    """One optimizer (and momentum state) per partition: torch SGD with
    Nesterov momentum and coupled weight decay (``torch_sgd``); the lr is
    set before every step."""
    return {
        name: torch.optim.SGD(partition_params(model, keys), lr=0.0, momentum=momentum,
                              nesterov=True, weight_decay=weight_decay)
        for name, keys in partitions.items()
    }


def step_partitions(optimizers: dict[str, torch.optim.SGD], names: tuple[str, ...],
                    lr: float, **hyper) -> None:
    """SGD-step the named partitions at ``lr`` (and any other group setting
    in ``hyper``, e.g. ``momentum``); the others keep their parameters and
    momentum. A parameter the loss did not reach gets a zero gradient, so
    weight decay and momentum still move it, as in the JAX package (torch
    alone would skip it)."""
    for name in names:
        opt = optimizers[name]
        for group in opt.param_groups:
            group.update(lr=lr, **hyper)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()


def zero_grad(optimizers: dict[str, torch.optim.SGD], names: tuple[str, ...]) -> None:
    for name in names:
        optimizers[name].zero_grad(set_to_none=True)


def da_lr(
    step: int,
    *,
    base_lr: float = 0.01,
    gamma: float = 1e-4,
    decay: float = 0.75,
    optimizer_lr: float = 0.1,
) -> float:
    """Per-iteration DA learning rate ``optimizer_lr * base_lr *
    (1 + gamma * i)^(-decay)`` (``train1.py:141-149``), in float32 as the JAX
    package computes it, returned as a host float."""
    i = np.float32(step)
    factor = (np.float32(1.0) + np.float32(gamma) * i) ** np.float32(-decay)
    return float(np.float32(optimizer_lr * base_lr) * factor)


def pretrain_lr_factor(
    epoch: int, *, milestones: tuple[int, ...] = (45, 60), factor: float = 0.1
) -> float:
    """MultiStepLR factor for the pretrain phase, with the reference's quirk:
    ``lr_scheduler.step()`` runs BEFORE each epoch (``train1.py:164-167``), so
    during 0-indexed epoch ``e`` the scheduler has counted ``e + 1`` steps."""
    count = epoch + 1
    return float(factor ** sum(1 for m in milestones if m <= count))
