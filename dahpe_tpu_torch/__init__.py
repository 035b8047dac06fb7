"""dahpe_tpu_torch — the PyTorch/CUDA port of ``dahpe_tpu`` for NVIDIA Hopper.

The package mirrors ``dahpe_tpu``'s module names so each counterpart is easy
to find, and keeps its public layouts: images ``(B, H, W, 3)``, heatmaps
``(B, H, W, K)``. It imports ``torch``, numpy and the standard library only;
the JAX package is its reference and is never imported here.

Subpackages are not imported eagerly: the CUDA kernels build at their first
launch, never at import.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device entry points run on unless the caller names another.

    The port targets the card, so this is ``cuda`` even where no card is
    present: a CPU run must ask for ``device="cpu"`` explicitly.
    """
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` if None."""
    return default_device() if device is None else torch.device(device)


def set_float32_policy() -> None:
    """Run float32 in full float32 on the card: no TF32 in matmul or cuDNN.

    TF32 keeps about three decimal digits, and the port is held to the JAX
    reference at float32 tolerances.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
