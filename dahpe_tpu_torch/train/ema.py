"""Exponential moving average of a model's parameters and BN statistics.

Port of ``dahpe_tpu/train/ema.py`` (``update_ema_variables5`` semantics,
``uda/model/loss.py:252-261``): every entry, parameters AND batch-norm
running stats, follows ``v_ema = m * v_ema + (1 - m) * v``.
"""

from __future__ import annotations

import torch


def ema_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The entries an EMA follows: every parameter and every BN running
    mean and variance of ``model``, by state-dict key (live tensors)."""
    out = {name: p for name, p in model.named_parameters()}
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            out[name] = buf
    return out


@torch.no_grad()
def ema_update(ema_tree: dict[str, torch.Tensor], tree: dict[str, torch.Tensor],
               decay: float) -> dict[str, torch.Tensor]:
    """``ema = decay * ema + (1 - decay) * value`` for every key of
    ``ema_tree``, in place (two fused multi-tensor launches); returns it."""
    keys = list(ema_tree)
    ema = [ema_tree[k] for k in keys]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [tree[k].detach() for k in keys], alpha=1.0 - decay)
    return ema_tree
