"""Custom ops: the hand-written CUDA kernels (Gaussian targets, Paeth
rotation, fused pseudo-labels) and the GL gradient scaler.

Importing this package builds nothing; each kernel builds at its first
launch (``ops/_build.py``).
"""

from dahpe_tpu_torch.ops.gradient_scale import gradient_scale, warm_start_coeff

__all__ = ["gradient_scale", "warm_start_coeff"]
