"""dahpe_tpu_torch — the PyTorch/CUDA port of ``dahpe_tpu`` for NVIDIA Hopper.

The package mirrors ``dahpe_tpu``'s module names so each counterpart is easy
to find, and keeps its public layouts: images ``(B, H, W, 3)``, heatmaps
``(B, H, W, K)``. It imports ``torch``, numpy and the standard library only;
the JAX package is its reference and is never imported here.

Subpackages are not imported eagerly: the CUDA kernels build at their first
launch, never at import. The package itself imports torch only when a
function needs it, so the serving client (:mod:`dahpe_tpu_torch.client`)
runs where torch is not installed.
"""

from __future__ import annotations

__version__ = "0.1.0"


def default_device():
    """The device entry points run on unless the caller names another.

    The port targets the card, so this is ``cuda`` even where no card is
    present: a CPU run must ask for ``device="cpu"`` explicitly.
    """
    import torch

    return torch.device("cuda")


def resolve_device(device=None):
    """``device`` as a ``torch.device``, or :func:`default_device` if None."""
    import torch

    return default_device() if device is None else torch.device(device)


def set_float32_policy() -> None:
    """Run float32 in full float32 on the card: no TF32 in matmul or cuDNN.

    TF32 keeps about three decimal digits, and the port is held to the JAX
    reference at float32 tolerances.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
