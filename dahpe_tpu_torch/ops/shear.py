"""Paeth rotation and shears of training canvases: the CUDA kernels and
their plain twins.

Ports of the three TPU kernels of ``dahpe_tpu/ops/pallas/shear.py``, all
modes of one CUDA source, ``dahpe_tpu_torch/csrc/rotate3.cu`` (its header
says what bounds them and how its design answers that):

- :func:`rotate3_fused` (``rotate3_fused_pallas``), with the quarter-turn and
  layout glue of ``dahpe_tpu/data/device_aug.py:_rotate_shears``: uint8 or
  float32 ``(B, S, S, C)`` crops in ``[0, 255]`` → rotated ``(B, C, S, S)``
  float32. The training producer's rotation.
- :func:`rotate3` (``rotate3_pallas``): ``ShX(a)·ShY(b)·ShX(a)`` of padded
  8.8 fixed-point ``(B, C, H, W)`` ``torch.uint16`` canvases.
- :func:`shear` (``shear_pallas``): one bilinear shear of such canvases.

Per-image slopes ``(B,)`` replace the JAX package's ``vmap``. The plain
versions (``*_plain``) are the JAX package's masked-shift shears
(``_shift_rows_x``, ``_shear_x``, ``_shear_y``), held in int32 here because
torch has little uint16 arithmetic (the values are the same integers).

Each dispatcher takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; there is no fallback. Each
kernel mode counts its launches in a module counter.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from dahpe_tpu_torch.ops import _build

LIB_NAME = "rotate3"
SOURCES = ["rotate3.cu"]

# kernel launches since the last reset: rotate3_fused_cuda on uint8 crops
# (the training path), on float32 crops, rotate3_cuda and shear_cuda
launches = 0
fused_f32_launches = 0
rotate3_launches = 0
shear_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rotate3_fused_u8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "rotate3_fused_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "rotate3_u16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "shear_u16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
}


# rotate3_fused's tiles (csrc/rotate3.cu: kTile) and the slope caps its
# shared memory is sized for: just above the path's |a| <= tan(22.5°) and
# |b| <= sin(45°) (data/device_aug.py:rotation_slopes), so float32 rounding
# of the slopes stays inside
TILE = 32
SLOPE_CAPS = (0.4143, 0.7072)
MAX_STAGED_CHANNELS = 4  # channels that fit one packed word (csrc/rotate3.cu)
# the one-shear mode (csrc/rotate3.cu: shear_x_kernel, shear_y_kernel): ShY's
# tiles are SHEAR_COLS threads wide (one or two columns each) by at most
# SHEAR_ROWS rows, a multiple of SHEAR_ROW_STEP; a block's window of input
# rows takes at most SHEAR_WINDOW_BYTES of shared memory (seven blocks an SM)
SHEAR_COLS, SHEAR_ROWS, SHEAR_ROW_STEP = 32, 128, 8
SHEAR_WINDOW_BYTES = 32 * 1024


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME, SOURCES)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """``torch.uint16`` → int32 with the same values, through an int16 view
    (casts out of uint16 are not implemented everywhere)."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def i32_to_u16(x: torch.Tensor) -> torch.Tensor:
    """int32 values in ``[0, 65535]`` → ``torch.uint16``, through int16."""
    return torch.where(x > 32767, x - 65536, x).to(torch.int16).view(torch.uint16)


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


def _spread(slope: float, lines: int) -> int:
    """A bound on ``max d - min d`` of the integer shift
    ``d(l) = clip(floor(t (l - c)))`` over ``lines + 1`` consecutive lines for
    ``|t| <= slope``: ``ceil(|t| lines)``, plus 1 for the float32 rounding of
    the two products."""
    return math.ceil(abs(slope) * lines) + 1


def stage_box_shape() -> tuple[int, int]:
    """``(rows, cols)`` in ``P`` of the largest box of canvas pixels whose
    taps one ``TILE x TILE`` output tile of ``rotate3_fused`` can reach at
    slopes within ``SLOPE_CAPS``: the tile's rows give ``w2`` S2 columns,
    those give ``h1`` S1 rows, those ``w1`` columns of ``P``
    (``csrc/rotate3.cu:tile_footprint`` walks the same chain for the actual
    slopes, and cuts it to the image). The kernel copies this box's source
    rows (uint8) and stages only the taps inside it (:func:`stage_capacity`)."""
    cap_a, cap_b = SLOPE_CAPS
    w2 = TILE + _spread(cap_a, TILE - 1) + 1
    h1 = TILE + _spread(cap_b, w2 - 1) + 1
    w1 = w2 + _spread(cap_a, h1 - 1) + 1
    return h1, w1


def stage_words(cols2: int, tile_rows: int, rows1: int) -> int:
    """Packed words ``csrc/rotate3.cu:rotate3_fused_kernel`` stages at most
    for a tile of ``tile_rows`` rows whose taps span ``cols2`` S2 columns and
    ``rows1`` S1 rows: a zero run of ``cols2 + 1`` words (the taps of S1 rows
    outside the image), then for each S1 row one word per tap, the S2
    columns that read it and one more. Each S2 column reads ``tile_rows + 1``
    S1 rows, so the rows' columns add up to ``cols2 * (tile_rows + 1)``."""
    return cols2 + 1 + cols2 * (tile_rows + 1) + rows1


def stage_capacity(channels: int) -> int:
    """Packed words of shared memory a block of ``rotate3_fused`` or
    ``rotate3_u16`` stages its taps in: :func:`stage_words` of a full tile at
    slopes within ``SLOPE_CAPS`` (the ``w2`` S2 columns and ``h1`` S1 rows of
    :func:`stage_box_shape`'s chain, which the slopes alone bound, whatever
    the canvas), or 0 when ``channels`` do not fit one word and every tile
    takes the kernel's direct walk."""
    if channels > MAX_STAGED_CHANNELS:
        return 0
    w2 = TILE + _spread(SLOPE_CAPS[0], TILE - 1) + 1
    h1, _ = stage_box_shape()
    return stage_words(w2, TILE, h1)


def stage_raw_bytes(channels: int, itemsize: int) -> int:
    """Bytes of shared memory a block of ``rotate3_fused`` copies the source
    rows of its footprint into before packing them (uint8 crops; float32
    ones pack straight from global memory, 0): one row of the box (the
    footprint turned back onto the image, ``h1 x w1`` or ``w1 x h1``) is a run
    of ``cols * channels`` bytes, copied in the 16-byte aligned chunks that
    cover it and one more, rounded up to an odd count (a column of the box
    then spreads over the shared-memory banks), so
    ``(((run + 15) // 16 + 1) | 1) * 16`` bytes a row."""
    if channels > MAX_STAGED_CHANNELS or itemsize != 1:
        return 0
    h1, w1 = stage_box_shape()

    def rows(count, cols):
        return count * (((cols * channels + 15) // 16 + 1) | 1) * 16
    return max(rows(h1, w1), rows(w1, h1))


def shear_x_groups(width: int) -> int:
    """Threads a row of ``csrc/rotate3.cu:shear_x_kernel`` takes: one per
    aligned 8-byte word a row of ``width`` pixels can touch at any phase."""
    return (width + 2) // 4 + 1


def shear_y_plan(height: int, width: int, kmax: int, pairs: bool | None = None) -> dict:
    """How ``csrc/rotate3.cu:shear_y_kernel`` tiles an ``H x W`` plane:
    ``pairs``, two columns a thread (4-byte loads and stores; rows must be
    4-byte aligned, so an even ``width``, the default, and an aligned
    canvas); ``cols`` columns and ``rows`` output rows a tile (the fewest row
    tiles of at most ``SHEAR_ROWS`` rows, evened out and rounded up to
    ``SHEAR_ROW_STEP``); ``tiles`` = (column tiles, row tiles); and
    ``capacity`` rows of ``cols`` pixels of shared memory (``shared_bytes``)
    for a block's window: the rows its taps can read, ``rows + 2 kmax + 1``
    (the shift lies in ``[-kmax, kmax]``) or ``H + 2`` (the plane and a zero
    row on each side), whichever is fewer, cut to ``SHEAR_WINDOW_BYTES``.
    Only where that cut binds (``direct_possible``) can a tile's window,
    ``rows`` plus the shift's spread over its columns, exceed the capacity
    and take the direct walk."""
    pairs = width % 2 == 0 if pairs is None else pairs
    cols = SHEAR_COLS * (2 if pairs else 1)
    per = -(-height // -(-height // SHEAR_ROWS))
    rows = -(-per // SHEAR_ROW_STEP) * SHEAR_ROW_STEP
    need = min(rows + 2 * kmax + 1, height + 2)
    capacity = max(1, min(need, SHEAR_WINDOW_BYTES // (2 * cols)))
    return {"pairs": pairs, "cols": cols, "rows": rows,
            "tiles": (-(-width // cols), -(-height // rows)), "capacity": capacity,
            "shared_bytes": capacity * cols * 2, "direct_possible": capacity < need}


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


def _check_cuda(name: str, args) -> None:
    if not all(t.is_cuda and t.device == args[0].device for t in args):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: inputs must be contiguous")
    if args[0].numel() >= 2**31:
        raise ValueError(f"{name}: the canvas must have fewer than 2^31 elements")


def rotate3_fused_cuda(
    images: torch.Tensor,
    slope_a: torch.Tensor,
    slope_b: torch.Tensor,
    quarter: torch.Tensor,
    *,
    pad: int,
    kmax_a: int,
    kmax_b: int,
    direct_tiles: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`rotate3_fused_plain` for contiguous uint8 or float32 ``images``,
    float32 slopes and int32 quarter-turns, all on one CUDA device.

    Each block stages its tile's taps in :func:`stage_capacity` words of
    shared memory (and :func:`stage_raw_bytes` of source rows); a tile that
    needs more takes the kernel's direct walk, with the same result.
    ``direct_tiles``, an int32 ``(1,)`` CUDA tensor, gets 1 added for each
    tile that took the direct walk."""
    global launches, fused_f32_launches
    args = (images, slope_a, slope_b, quarter)
    _check_cuda("rotate3_fused_cuda", args)
    if (images.dtype not in (torch.uint8, torch.float32) or images.dim() != 4
            or images.shape[1] != images.shape[2]):
        raise ValueError(
            f"rotate3_fused_cuda: need square uint8 or float32 images (B, S, S, C), got "
            f"{images.dtype} {tuple(images.shape)}"
        )
    b, size, _, c = images.shape
    if slope_a.dtype != torch.float32 or slope_b.dtype != torch.float32 or quarter.dtype != torch.int32:
        raise ValueError("rotate3_fused_cuda: need float32 slopes and int32 quarter-turns")
    if not all(tuple(t.shape) == (b,) for t in args[1:]):
        raise ValueError(f"rotate3_fused_cuda: slopes and quarter-turns must be ({b},)")
    if direct_tiles is not None and (direct_tiles.dtype != torch.int32
                                     or direct_tiles.device != images.device):
        raise ValueError("rotate3_fused_cuda: direct_tiles must be int32 beside the images")
    out = torch.empty((b, c, size, size), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    capacity = stage_capacity(c)
    raw_bytes = stage_raw_bytes(c, images.element_size())
    lib = _lib()
    fn = lib.rotate3_fused_u8 if images.dtype == torch.uint8 else lib.rotate3_fused_f32
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        _check_launch(fn(
            images.data_ptr(), slope_a.data_ptr(), slope_b.data_ptr(), quarter.data_ptr(),
            out.data_ptr(), b, size, c, int(pad), int(kmax_a), int(kmax_b), int(capacity),
            raw_bytes, None if direct_tiles is None else direct_tiles.data_ptr(), stream,
        ), "rotate3_fused")
    if images.dtype == torch.uint8:
        launches += 1
    else:
        fused_f32_launches += 1
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
    """The kernel for CUDA tensors (uint8 crops as they are, any other dtype
    as float32, as the Pallas kernel takes them), the plain version for CPU
    tensors."""
    kw = dict(pad=pad, kmax_a=kmax_a, kmax_b=kmax_b)
    if images.device.type == "cuda":
        if images.dtype != torch.uint8:
            images = images.to(torch.float32)
        return rotate3_fused_cuda(
            images.contiguous(), slope_a.to(torch.float32).contiguous(),
            slope_b.to(torch.float32).contiguous(),
            (quarter.to(torch.int32) % 4).contiguous(), **kw,
        )
    if images.device.type == "cpu":
        return rotate3_fused_plain(images, slope_a, slope_b, quarter, **kw)
    raise ValueError(f"rotate3_fused: no kernel for device {images.device}")


# ---- kernels 4 and 5: the shears of a uint16 canvas that is already padded

def _check_u16(name: str, images: torch.Tensor) -> None:
    if images.dtype != torch.uint16 or images.dim() != 4:
        raise ValueError(f"{name}: need uint16 canvases (B, C, H, W), got "
                         f"{images.dtype} {tuple(images.shape)}")


def shear_plain(images: torch.Tensor, slope: torch.Tensor, *, kmax: int,
                axis: int = 2) -> torch.Tensor:
    """Plain PyTorch version of :func:`shear`: ``ShX`` (``axis=2``, each row
    shifted along W about the middle row) or ``ShY`` (``axis=1``, each column
    shifted along H about the middle column) of ``(B, C, H, W)`` uint16
    canvases with per-image slopes ``(B,)``."""
    _check_u16("shear_plain", images)
    fn = {2: _shear_x, 1: _shear_y}[axis]
    return i32_to_u16(fn(u16_to_i32(images), slope.to(torch.float32), kmax))


def rotate3_plain(images: torch.Tensor, slope_a: torch.Tensor, slope_b: torch.Tensor, *,
                  kmax_a: int, kmax_b: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`rotate3`: ``ShX(a)·ShY(b)·ShX(a)`` of
    ``(B, C, H, W)`` uint16 canvases, each shear rounded to 8.8 in turn."""
    _check_u16("rotate3_plain", images)
    a, b = slope_a.to(torch.float32), slope_b.to(torch.float32)
    x = _shear_x(u16_to_i32(images), a, kmax_a)
    x = _shear_y(x, b, kmax_b)
    return i32_to_u16(_shear_x(x, a, kmax_a))


def shear_cuda(images: torch.Tensor, slope: torch.Tensor, *, kmax: int,
               axis: int = 2, direct_tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the one-shear kernel on the current stream; contiguous uint16
    ``images`` and float32 ``slope`` on one CUDA device. ShX shifts each row
    in aligned 8-byte words; ShY stages each tile's window of rows in shared
    memory (:func:`shear_y_plan`), two columns a thread where the canvas's
    rows are 4-byte aligned. ``direct_tiles``, an int32 ``(1,)`` CUDA
    tensor, gets 1 added for each ShY tile whose window exceeded the
    allocation and read its taps from global memory instead."""
    global shear_launches
    _check_u16("shear_cuda", images)
    _check_cuda("shear_cuda", (images, slope))
    b, c, h, w = images.shape
    if slope.dtype != torch.float32 or tuple(slope.shape) != (b,):
        raise ValueError(f"shear_cuda: need a float32 slope per image, ({b},)")
    if axis not in (1, 2):
        raise ValueError(f"shear_cuda: axis must be 1 or 2, got {axis}")
    if direct_tiles is not None and (direct_tiles.dtype != torch.int32
                                     or direct_tiles.device != images.device):
        raise ValueError("shear_cuda: direct_tiles must be int32 beside the images")
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    plan = shear_y_plan(h, w, int(kmax), pairs=w % 2 == 0 and images.data_ptr() % 4 == 0)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        _check_launch(_lib().shear_u16(
            images.data_ptr(), slope.data_ptr(), out.data_ptr(), b, c, h, w, int(kmax),
            int(axis), int(plan["pairs"]), plan["rows"], plan["capacity"],
            None if direct_tiles is None else direct_tiles.data_ptr(), stream), "shear")
    shear_launches += 1
    return out


def rotate3_cuda(images: torch.Tensor, slope_a: torch.Tensor, slope_b: torch.Tensor, *,
                 kmax_a: int, kmax_b: int,
                 direct_tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the three-shear kernel on the current stream; contiguous
    uint16 ``images`` and float32 slopes on one CUDA device.

    Each block stages its tile's taps in :func:`stage_capacity` words of
    shared memory; a tile that needs more takes the kernel's direct walk,
    with the same result. ``direct_tiles``, an int32 ``(1,)``
    CUDA tensor, gets 1 added for each tile that took the direct walk."""
    global rotate3_launches
    _check_u16("rotate3_cuda", images)
    _check_cuda("rotate3_cuda", (images, slope_a, slope_b))
    b, c, h, w = images.shape
    if not all(t.dtype == torch.float32 and tuple(t.shape) == (b,) for t in (slope_a, slope_b)):
        raise ValueError(f"rotate3_cuda: need float32 slopes per image, ({b},)")
    if direct_tiles is not None and (direct_tiles.dtype != torch.int32
                                     or direct_tiles.device != images.device):
        raise ValueError("rotate3_cuda: direct_tiles must be int32 beside the images")
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    capacity = stage_capacity(c)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        _check_launch(_lib().rotate3_u16(
            images.data_ptr(), slope_a.data_ptr(), slope_b.data_ptr(), out.data_ptr(),
            b, c, h, w, int(kmax_a), int(kmax_b), capacity,
            None if direct_tiles is None else direct_tiles.data_ptr(), stream), "rotate3")
    rotate3_launches += 1
    return out


def shear(images: torch.Tensor, slope: torch.Tensor, *, kmax: int, axis: int = 2) -> torch.Tensor:
    """One bilinear shear of ``(B, C, H, W)`` uint16 8.8 canvases with
    per-image slopes ``(B,)``: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if images.device.type == "cuda":
        return shear_cuda(images.contiguous(), slope.to(torch.float32).contiguous(),
                          kmax=kmax, axis=axis)
    if images.device.type == "cpu":
        return shear_plain(images, slope, kmax=kmax, axis=axis)
    raise ValueError(f"shear: no kernel for device {images.device}")


def rotate3(images: torch.Tensor, slope_a: torch.Tensor, slope_b: torch.Tensor, *,
            kmax_a: int, kmax_b: int) -> torch.Tensor:
    """``ShX(a)·ShY(b)·ShX(a)`` of ``(B, C, H, W)`` uint16 8.8 canvases (``H``
    may differ from ``W``) with per-image slopes: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(kmax_a=kmax_a, kmax_b=kmax_b)
    if images.device.type == "cuda":
        return rotate3_cuda(images.contiguous(), slope_a.to(torch.float32).contiguous(),
                            slope_b.to(torch.float32).contiguous(), **kw)
    if images.device.type == "cpu":
        return rotate3_plain(images, slope_a, slope_b, **kw)
    raise ValueError(f"rotate3: no kernel for device {images.device}")
