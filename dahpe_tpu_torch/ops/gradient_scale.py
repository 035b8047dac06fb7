"""Warm-start gradient scaling — the reference's GL layer.

Port of ``dahpe_tpu/ops/gradient_scale.py``: identity forward, backward
multiplies the gradient by a coefficient that is a pure function of the step
count (``utils/gl.py:8-69`` of the reference). The coefficient may be a
device tensor computed from a device step count.
"""

from __future__ import annotations

import torch


class _GradientScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff):
        # λ in x's dtype (bfloat16 rounds it). A host float stays a host
        # float, rounded on the host: copying it to the card would make the
        # copy wait for the stream
        if isinstance(coeff, torch.Tensor):
            ctx.coeff = coeff.to(x.dtype)
        else:
            ctx.coeff = float(torch.tensor(float(coeff), dtype=x.dtype))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.coeff, None


def gradient_scale(x: torch.Tensor, coeff) -> torch.Tensor:
    """Identity forward; backward scales ``dx`` by ``coeff`` rounded to
    ``x``'s dtype (no grad to coeff): a host float, or a tensor on the CPU
    (0-d) or beside ``x``."""
    return _GradientScale.apply(x, coeff)


def warm_start_coeff(
    step,
    *,
    alpha: float = 1.0,
    lo: float = 0.0,
    hi: float = 0.1,
    max_iters: int = 1000,
) -> torch.Tensor:
    """λ(i) = 2(hi-lo) / (1 + exp(-α i / N)) - (hi-lo) + lo, in float32: a
    0-d tensor on the device of ``step`` (a host int gives a CPU tensor). A
    device step count gives λ on the device with no host read, so a captured
    iteration computes each replay's own λ."""
    i = torch.as_tensor(step, dtype=torch.float32)
    span = hi - lo
    return 2.0 * span / (1.0 + torch.exp(-alpha * i / max_iters)) - span + lo
