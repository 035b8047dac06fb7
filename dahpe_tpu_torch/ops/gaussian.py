"""Windowed-Gaussian heatmap rendering: the CUDA kernel and its plain twin.

Port of the TPU kernel ``dahpe_tpu/ops/pallas/gaussian.py:render_gaussian_pallas``.
The kernel lives in ``dahpe_tpu_torch/csrc/render_gaussian.cu`` (its header
says what bounds it and how its design answers that); this module builds,
binds and launches it, and holds :func:`render_gaussian_plain`, the same
function in plain PyTorch.

:func:`render_gaussian` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from dahpe_tpu_torch.ops import _build

LIB_NAME = "render_gaussian"
SOURCES = ["render_gaussian.cu"]

# kernel launches made by render_gaussian_cuda since the last reset
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME, SOURCES)
    fn = lib.render_gaussian_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _two_sigma_sq(sigma: float) -> float:
    # computed in double and rounded to float32 by ctypes, as the reference's
    # Python-float constant is rounded when it meets a float32 array
    return 2.0 * sigma * sigma


def render_gaussian_plain(
    mu: torch.Tensor,
    valid: torch.Tensor,
    *,
    height: int,
    width: int,
    sigma: float = 2.0,
    reach: int = 6,
) -> torch.Tensor:
    """Plain PyTorch version: ``mu (B, K, 2)`` int peaks ``(x, y)``,
    ``valid (B, K)`` mask (nonzero = render) → ``(B, H, W, K)`` float32."""
    mu = mu.to(torch.int32)
    mu_x = mu[..., 0][:, None, None, :]  # (B, 1, 1, K)
    mu_y = mu[..., 1][:, None, None, :]
    xs = torch.arange(width, dtype=torch.int32, device=mu.device)[None, :, None]
    ys = torch.arange(height, dtype=torch.int32, device=mu.device)[:, None, None]
    dx = xs - mu_x  # (B, 1, W, K)
    dy = ys - mu_y  # (B, H, 1, K)
    d2 = (dx * dx + dy * dy).to(torch.float32)
    g = torch.exp(-d2 / _two_sigma_sq(sigma))
    inside = (dx.abs() <= reach) & (dy.abs() <= reach)
    keep = inside & (valid[:, None, None, :] > 0)
    return torch.where(keep, g, torch.zeros((), dtype=torch.float32, device=mu.device))


def render_gaussian_cuda(
    mu: torch.Tensor,
    valid: torch.Tensor,
    *,
    height: int,
    width: int,
    sigma: float = 2.0,
    reach: int = 6,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`render_gaussian_plain`. ``mu`` must be contiguous int32 and
    ``valid`` contiguous float32, both on one CUDA device."""
    global launches
    if not (mu.is_cuda and valid.is_cuda and mu.device == valid.device):
        raise ValueError("render_gaussian_cuda: mu and valid must be on one CUDA device")
    if mu.dtype != torch.int32 or valid.dtype != torch.float32:
        raise TypeError(
            f"render_gaussian_cuda: need int32 mu and float32 valid, got "
            f"{mu.dtype} and {valid.dtype}"
        )
    if mu.dim() != 3 or mu.shape[-1] != 2 or tuple(valid.shape) != tuple(mu.shape[:2]):
        raise ValueError(
            f"render_gaussian_cuda: need mu (B, K, 2) and valid (B, K), got "
            f"{tuple(mu.shape)} and {tuple(valid.shape)}"
        )
    if not (mu.is_contiguous() and valid.is_contiguous()):
        raise ValueError("render_gaussian_cuda: inputs must be contiguous")
    b, k, _ = mu.shape
    if b * height * width * k >= 2**31:
        raise ValueError("render_gaussian_cuda: the output must have fewer than 2^31 elements")
    if not -(2**31) <= int(reach) < 2**31:
        raise ValueError(f"render_gaussian_cuda: reach {reach} does not fit int32")
    if mu.data_ptr() % 8:  # the kernel reads each peak as one 8-byte load
        mu = mu.clone()
    out = torch.empty((b, height, width, k), dtype=torch.float32, device=mu.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream(mu.device).cuda_stream
        err = lib.render_gaussian_f32(
            mu.data_ptr(), valid.data_ptr(), out.data_ptr(),
            b, int(height), int(width), k,
            _two_sigma_sq(sigma), int(reach), stream,
        )
    if err != 0:
        raise RuntimeError(f"render_gaussian kernel launch failed: cudaError {err}")
    launches += 1
    return out


def render_gaussian(
    mu: torch.Tensor,
    valid: torch.Tensor,
    *,
    height: int,
    width: int,
    sigma: float = 2.0,
    reach: int = 6,
) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if mu.device.type == "cuda":
        return render_gaussian_cuda(
            mu.to(torch.int32).contiguous(), valid.to(torch.float32).contiguous(),
            height=height, width=width, sigma=sigma, reach=reach,
        )
    if mu.device.type == "cpu":
        return render_gaussian_plain(
            mu, valid, height=height, width=width, sigma=sigma, reach=reach
        )
    raise ValueError(f"render_gaussian: no kernel for device {mu.device}")
