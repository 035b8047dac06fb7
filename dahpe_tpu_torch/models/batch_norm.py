"""BatchNorm with the reference's torch semantics.

Counterpart of ``dahpe_tpu/models/batch_norm.py``, which re-creates torch's
``nn.BatchNorm2d`` in Flax: running stats update as
``running = (1 - momentum) * running + momentum * new`` with momentum 0.1,
the running variance takes the unbiased batch variance, eps is 1e-5. Here
that is torch's own layer; the class pins the two constants so the source of
truth is one place in both packages.
"""

from __future__ import annotations

from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with momentum 0.1 and eps 1e-5 pinned."""

    def __init__(self, num_features: int, *, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)
