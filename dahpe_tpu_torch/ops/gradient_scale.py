"""Warm-start gradient scaling — the reference's GL layer.

Port of ``dahpe_tpu/ops/gradient_scale.py``: identity forward, backward
multiplies the gradient by a coefficient that is a pure function of the step
count (``utils/gl.py:8-69`` of the reference).
"""

from __future__ import annotations

import torch


class _GradientScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff):
        ctx.save_for_backward(torch.as_tensor(coeff, dtype=x.dtype, device=x.device))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (coeff,) = ctx.saved_tensors
        return g * coeff, None


def gradient_scale(x: torch.Tensor, coeff) -> torch.Tensor:
    """Identity forward; backward scales ``dx`` by ``coeff`` (no grad to coeff)."""
    return _GradientScale.apply(x, coeff)


def warm_start_coeff(
    step,
    *,
    alpha: float = 1.0,
    lo: float = 0.0,
    hi: float = 0.1,
    max_iters: int = 1000,
) -> torch.Tensor:
    """λ(i) = 2(hi-lo) / (1 + exp(-α i / N)) - (hi-lo) + lo, in float32."""
    i = torch.as_tensor(step, dtype=torch.float32)
    span = hi - lo
    return 2.0 * span / (1.0 + torch.exp(-alpha * i / max_iters)) - span + lo
