"""Paeth rotation of training canvases: the CUDA kernel and its plain twin.

Port of the TPU kernel ``dahpe_tpu/ops/pallas/shear.py:rotate3_fused_pallas``
together with the quarter-turn and layout glue of
``dahpe_tpu/data/device_aug.py:_rotate_shears``. The kernel lives in
``dahpe_tpu_torch/csrc/rotate3.cu`` (its header says what bounds it and how
its design answers that); this module builds, binds and launches it, and
holds :func:`rotate3_fused_plain`, the same function in plain PyTorch: the
JAX package's masked-shift shears (``_shift_rows_x``, ``_shear_x``,
``_shear_y``) on 8.8 fixed-point canvases, held in int32 here because torch
has little uint16 arithmetic (the values are the same integers).

:func:`rotate3_fused` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from dahpe_tpu_torch.ops import _build

LIB_NAME = "rotate3"
SOURCES = ["rotate3.cu"]

# kernel launches made by rotate3_fused_cuda since the last reset
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME, SOURCES)
    fn = lib.rotate3_fused_u8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def rotation_geometry(size: int) -> tuple[int, int, int]:
    """``(pad, kmax_a, kmax_b)`` for square ``size`` crops, as
    ``device_aug._rotate_shears`` sets them: a sqrt(2) margin so the
    intermediate shears never clip, and the integer-shift bounds of the
    ``tan(22.5°)`` and ``sin(45°)`` slopes on the padded canvas."""
    pad = int(np.ceil(0.2072 * size)) + 2
    n = size + 2 * pad
    kmax_a = int(np.ceil(0.41422 * (n - 1) / 2.0)) + 1
    kmax_b = int(np.ceil(0.70711 * (n - 1) / 2.0)) + 1
    return pad, kmax_a, kmax_b


def _to_fixed(x: torch.Tensor) -> torch.Tensor:
    """uint8 or float ``[0, 255]`` canvas → 8.8 fixed point (int32 values
    in ``[0, 65535]``); exact on uint8 and on integral floats."""
    if x.dtype == torch.uint8:
        return x.to(torch.int32) * 256
    return torch.clamp(torch.round(x.to(torch.float32) * 256.0), 0.0, 65535.0).to(torch.int32)


def _shift_rows_x(image: torch.Tensor, k: torch.Tensor, kmax: int) -> torch.Tensor:
    """Per-row integer shift ``out[..., y, x] = image[..., y, x + k[y]]``,
    zero-filled, by masked static shifts (one per bit of ``k + kmax``);
    returns one extra column for the blend's second tap."""
    w = image.shape[-1]
    work = F.pad(image, (kmax, kmax))
    kk = torch.clamp(k + kmax, 0, 2 * kmax)
    for level in range(max(1, (2 * kmax).bit_length())):
        step = 1 << level
        shifted = F.pad(work[..., step:], (0, step))
        bit = ((kk >> level) & 1).to(torch.bool)
        work = torch.where(bit[..., None], shifted, work)
    return work[..., : w + 1]


def _shear_x(image: torch.Tensor, slope: torch.Tensor, kmax: int) -> torch.Tensor:
    """Bilinear x-shear about the centre of ``(B, C, H, W)`` fixed-point
    canvases, ``out[y, x] = image[y, x + slope[b] * (y - cy)]``: the integer
    part by :func:`_shift_rows_x`, one rounded 2-tap blend on top."""
    h, w = image.shape[-2:]
    y = torch.arange(h, dtype=torch.float32, device=image.device)
    s = slope.to(torch.float32)[:, None] * (y - (h - 1) / 2.0)  # (B, H)
    k = torch.floor(s)
    w2 = torch.round((s - k) * 256.0).to(torch.int32)[:, None, :, None]
    base = _shift_rows_x(image, k.to(torch.int32)[:, None, :], kmax)
    lo, hi = base[..., :w], base[..., 1 : w + 1]
    return (lo * (256 - w2) + hi * w2 + 128) >> 8


def _shear_y(image: torch.Tensor, slope: torch.Tensor, kmax: int) -> torch.Tensor:
    return _shear_x(image.transpose(-2, -1), slope, kmax).transpose(-2, -1)


def _quarter_turn(image: torch.Tensor, quarter: torch.Tensor) -> torch.Tensor:
    """``rot90(image[b], quarter[b])`` over the last two axes, per image,
    chosen on the device (no host read of ``quarter``)."""
    turns = torch.stack([torch.rot90(image, k, dims=(-2, -1)) for k in range(4)], dim=1)
    index = (quarter.to(torch.int64) % 4).view(-1, 1, *([1] * (image.dim() - 1)))
    return torch.take_along_dim(turns, index, dim=1)[:, 0]


def rotate3_fused_plain(
    images: torch.Tensor,
    slope_a: torch.Tensor,
    slope_b: torch.Tensor,
    quarter: torch.Tensor,
    *,
    pad: int,
    kmax_a: int,
    kmax_b: int,
) -> torch.Tensor:
    """Plain PyTorch version: ``images (B, H, W, C)`` uint8 or float in
    ``[0, 255]``, per-image slopes and quarter-turns ``(B,)`` → the rotated
    ``(B, C, H, W)`` float32 canvases, 1/256-quantized."""
    _, h, w, _ = images.shape
    x = F.pad(_to_fixed(images.permute(0, 3, 1, 2)), (pad, pad, pad, pad))
    x = _quarter_turn(x, quarter)
    x = _shear_x(x, slope_a, kmax_a)
    x = _shear_y(x, slope_b, kmax_b)
    x = _shear_x(x, slope_a, kmax_a)
    return x[..., pad : pad + h, pad : pad + w].to(torch.float32) * (1.0 / 256.0)


def rotate3_fused_cuda(
    images: torch.Tensor,
    slope_a: torch.Tensor,
    slope_b: torch.Tensor,
    quarter: torch.Tensor,
    *,
    pad: int,
    kmax_a: int,
    kmax_b: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`rotate3_fused_plain` for contiguous uint8 ``images``, float32
    slopes and int32 quarter-turns, all on one CUDA device."""
    global launches
    args = (images, slope_a, slope_b, quarter)
    if not all(t.is_cuda and t.device == images.device for t in args):
        raise ValueError("rotate3_fused_cuda: all inputs must be on one CUDA device")
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[1] != images.shape[2]:
        raise ValueError(
            f"rotate3_fused_cuda: need square uint8 images (B, S, S, C), got "
            f"{images.dtype} {tuple(images.shape)}"
        )
    b, size, _, c = images.shape
    if slope_a.dtype != torch.float32 or slope_b.dtype != torch.float32 or quarter.dtype != torch.int32:
        raise ValueError("rotate3_fused_cuda: need float32 slopes and int32 quarter-turns")
    if not all(tuple(t.shape) == (b,) for t in args[1:]):
        raise ValueError(f"rotate3_fused_cuda: slopes and quarter-turns must be ({b},)")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("rotate3_fused_cuda: inputs must be contiguous")
    if b * c * size * size >= 2**31:
        raise ValueError("rotate3_fused_cuda: the output must have fewer than 2^31 elements")
    out = torch.empty((b, c, size, size), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.rotate3_fused_u8(
            images.data_ptr(), slope_a.data_ptr(), slope_b.data_ptr(), quarter.data_ptr(),
            out.data_ptr(), b, size, c, int(pad), int(kmax_a), int(kmax_b), stream,
        )
    if err != 0:
        raise RuntimeError(f"rotate3 kernel launch failed: cudaError {err}")
    launches += 1
    return out


def rotate3_fused(
    images: torch.Tensor,
    slope_a: torch.Tensor,
    slope_b: torch.Tensor,
    quarter: torch.Tensor,
    *,
    pad: int,
    kmax_a: int,
    kmax_b: int,
) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(pad=pad, kmax_a=kmax_a, kmax_b=kmax_b)
    if images.device.type == "cuda":
        return rotate3_fused_cuda(
            images.contiguous(), slope_a.to(torch.float32).contiguous(),
            slope_b.to(torch.float32).contiguous(),
            (quarter.to(torch.int32) % 4).contiguous(), **kw,
        )
    if images.device.type == "cpu":
        return rotate3_fused_plain(images, slope_a, slope_b, quarter, **kw)
    raise ValueError(f"rotate3_fused: no kernel for device {images.device}")
