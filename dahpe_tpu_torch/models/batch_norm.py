"""BatchNorm with the reference's torch semantics, and global statistics
under data parallelism.

Counterpart of ``dahpe_tpu/models/batch_norm.py``, which re-creates torch's
``nn.BatchNorm2d`` in Flax: running stats update as
``running = (1 - momentum) * running + momentum * new`` with momentum 0.1,
the running variance takes the unbiased batch variance, eps is 1e-5. Here
that is torch's own layer; the class pins the two constants so the source of
truth is one place in both packages.

In a bfloat16 model (``dtype=torch.bfloat16``) the layer takes the
convolutions' bfloat16 output and, as the JAX layer does, computes the
statistics and the normalisation in float32 against its float32 affine
parameters and running statistics, and returns bfloat16: ``F.batch_norm``
does exactly that for a bfloat16 input with float32 parameters, on the CPU
and on the card.

Cross-rank mode (:func:`set_process_group`): under the JAX package's
data-parallel ``jit`` every mean over the batch axis is a mean over the
global batch, so batch statistics cover every rank's rows. A layer with a
process group of more than one rank does the same in training:
:class:`_CrossRankNorm` all-reduces the per-channel sum, sum of squares and
count in float32 (``var = E[x²] - E[x]²``, as the JAX layer), normalises
with the global statistics, and in backward all-reduces ``Σdy`` and
``Σdy·x̂``. Its weight and bias gradients are this rank's sums; the
trainer's gradient all-reduce averages them. It is plain tensor ops, so it
runs on gloo (CPU) and NCCL (card) alike, and NCCL's collectives are
captured with a CUDA graph. Without a group, at world size 1 and in eval
mode the layer is ``nn.BatchNorm2d``'s own forward.

The models call each layer through
:func:`~dahpe_tpu_torch.ops.batch_norm_act.batch_norm_act` with the ReLU
and the residual add that follow it (:func:`bn_relu_sequence` in the
``nn.Sequential`` stages): a bfloat16 training forward with local
statistics on a card runs as the fused kernels there, everything else as
this layer's forward, the add and the ReLU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from dahpe_tpu_torch.ops.batch_norm_act import batch_norm_act


class _CrossRankNorm(torch.autograd.Function):
    """``y = (x - mean)·invstd·weight + bias`` with global ``mean`` and
    ``invstd`` (computed from ``x`` without a graph); backward is the full
    batch-norm gradient with the per-channel sums all-reduced."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count, group):
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        shape = (1, -1, 1, 1)
        y = (x.float() - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c, shape = x.shape[1], (1, -1, 1, 1)
        dy32 = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        local = torch.cat([dy32.sum(dim=(0, 2, 3)), (dy32 * xhat).sum(dim=(0, 2, 3))])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = (sums / count).split(c)
        dx = (dy32 - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)) \
            * (invstd * weight).view(shape)
        return dx.to(x.dtype), local[c:], local[:c], None, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with momentum 0.1 and eps 1e-5 pinned, and the
    cross-rank mode of the module docstring."""

    process_group = None  # set by set_process_group; None: local statistics
    _cross_rank = False

    def __init__(self, num_features: int, *, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self._cross_rank and self.training):
            return super().forward(x)
        c, m = x.shape[1], self.momentum
        with torch.no_grad():
            x32 = x.detach().float()
            stats = torch.cat([x32.sum(dim=(0, 2, 3)), x32.square().sum(dim=(0, 2, 3)),
                               x32.new_full((1,), x.numel() // c)])
            dist.all_reduce(stats, group=self.process_group)
            total, total_sq, count = stats.split((c, c, 1))
            mean = total / count
            var = total_sq / count - mean.square()  # biased: normalises
            invstd = torch.rsqrt(var + self.eps)
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var * count / (count - 1), alpha=m)
        return _CrossRankNorm.apply(x, self.weight, self.bias, mean, invstd, count,
                                    self.process_group)


def set_process_group(module: nn.Module, group=None, *, enabled: bool = True) -> nn.Module:
    """Make every :class:`BatchNorm2d` of ``module`` take its training
    statistics over the ranks of ``group`` (default: every rank of the
    process group that is up); ``enabled=False`` goes back to local
    statistics. A group of one rank keeps the local layer. No state-dict key
    changes. Returns ``module``."""
    cross = enabled and dist.is_initialized() and dist.get_world_size(group) > 1
    for mod in module.modules():
        if isinstance(mod, BatchNorm2d):
            mod.process_group, mod._cross_rank = (group if cross else None), cross
    return module


def bn_relu_sequence(modules, x: torch.Tensor) -> torch.Tensor:
    """Run ``modules`` in order on ``x``, each :class:`BatchNorm2d` that an
    ``nn.ReLU`` follows as one ``batch_norm_act(..., relu=True)`` in place of
    the pair (the ReLU module stays in the tree and is skipped here)."""
    mods = list(modules)
    i = 0
    while i < len(mods):
        if (isinstance(mods[i], BatchNorm2d) and i + 1 < len(mods)
                and isinstance(mods[i + 1], nn.ReLU)):
            x = batch_norm_act(x, mods[i], relu=True)
            i += 2
        else:
            x = mods[i](x)
            i += 1
    return x
