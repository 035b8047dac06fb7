"""Partitioned SGD and learning-rate schedules with the reference's semantics.

Port of ``dahpe_tpu/train/optim.py``. The reference drives five separate
``torch.optim.SGD`` instances over disjoint parameter partitions, stepped in
different subsets per minimax sub-step (``train1.py:141-154, 392-397,
433-436, 450``). Here they are five ``torch.optim.SGD`` instances again; one
that is not stepped keeps its parameters and momentum frozen, which is what
the JAX package's ``apply_partition_updates`` reproduces with optax. Their
update order is ``torch_sgd``'s: weight decay added to the gradient before
the momentum trace, then the Nesterov lookahead.

The update itself is written with ``torch._foreach_*`` ops on a 0-d lr
tensor, so the lr can live on the device and change inside a captured CUDA
graph (``torch.optim.SGD`` reads a tensor lr back to the host). The DA lr
is :class:`StepTable`'s table of the host schedule :func:`da_lr`, indexed
by the device step count: the device reads the host function's bits.
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


@torch.no_grad()
def sgd_update(params: list[torch.Tensor], grads: list[torch.Tensor],
               momentum_buffers: list[torch.Tensor], lr: torch.Tensor, *,
               momentum: float, weight_decay: float) -> None:
    """``torch.optim.SGD``'s Nesterov step with coupled weight decay and no
    dampening, in place, with ``lr`` a 0-d tensor beside the parameters:
    ``d = g + wd·p``, ``buf = m·buf + d``, ``p -= lr·(d + m·buf)``. A zero
    buffer gives torch's first step (``buf = d``). No host read."""
    d = torch._foreach_add(grads, params, alpha=weight_decay)
    torch._foreach_mul_(momentum_buffers, momentum)
    torch._foreach_add_(momentum_buffers, d)
    torch._foreach_add_(d, momentum_buffers, alpha=momentum)
    torch._foreach_mul_(d, lr)
    torch._foreach_sub_(params, d)


def step_partitions(optimizers: dict[str, torch.optim.SGD], names: tuple[str, ...],
                    lr: torch.Tensor, **hyper) -> None:
    """SGD-step the named partitions at the 0-d tensor ``lr`` (and any other
    group setting in ``hyper``, e.g. ``momentum``) with :func:`sgd_update`;
    the others keep their parameters and momentum. Each optimizer keeps its
    momentum in ``state[p]["momentum_buffer"]``, as ``torch.optim.SGD``
    does (zeros until its first step). A parameter the loss did not reach
    gets a zero gradient, so weight decay and momentum still move it, as in
    the JAX package (torch alone would skip it)."""
    for name in names:
        opt = optimizers[name]
        for group in opt.param_groups:
            group.update(**hyper)
            params = group["params"]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if opt.state[p].get("momentum_buffer") is None:
                    opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
            sgd_update(params, [p.grad for p in params],
                       [opt.state[p]["momentum_buffer"] for p in params], lr,
                       momentum=group["momentum"], weight_decay=group["weight_decay"])


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


class StepTable:
    """A float32 function of the step count as a device tensor, read at a
    device step count with no host read: ``fn(step)`` evaluated on the host
    once per step into a table on the step's device, so the device value is
    the host function's bits (a float32 ``pow`` on the card rounds
    differently from the host's). :meth:`cover` extends the table before
    the steps that need it."""

    def __init__(self, fn, length: int = 1024):
        self.fn = fn
        self.length = int(length)
        self.values = np.zeros(0, np.float32)  # the host copy
        self.table: torch.Tensor | None = None

    def cover(self, stop: int, device) -> bool:
        """Make the table hold steps ``0 .. stop - 1`` on ``device``, doubling
        its length as needed. Returns True when the table moved to new
        memory (a CUDA graph that reads it must then be captured again)."""
        device = torch.device(device)
        if self.table is not None and self.table.device == device and stop <= len(self.table):
            return False
        while self.length < stop:
            self.length *= 2
        more = [self.fn(i) for i in range(len(self.values), self.length)]
        self.values = np.concatenate([self.values, np.asarray(more, np.float32)])
        self.table = torch.from_numpy(self.values).to(device)
        return True

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        """The 0-d float32 entry at the 0-d int64 device ``step``."""
        return self.table.index_select(0, step.reshape(1)).reshape(())


def pretrain_lr_factor(
    epoch: int, *, milestones: tuple[int, ...] = (45, 60), factor: float = 0.1
) -> float:
    """MultiStepLR factor for the pretrain phase, with the reference's quirk:
    ``lr_scheduler.step()`` runs BEFORE each epoch (``train1.py:164-167``), so
    during 0-indexed epoch ``e`` the scheduler has counted ``e + 1`` steps."""
    count = epoch + 1
    return float(factor ** sum(1 for m in milestones if m <= count))
