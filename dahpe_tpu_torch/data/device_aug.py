"""On-device batched augmentation (port of ``dahpe_tpu/data/device_aug.py``).

The reference augments per sample on the host with PIL: rotate → random
resized crop → colour jitter → Gaussian blur → normalize
(``train1.py:56-63``). Here the whole chain runs batched on the device: the
rotation is the three-shear (Paeth) kernel (:mod:`dahpe_tpu_torch.ops.shear`),
the crop-resize two interpolation-matrix products, then the photometric
ops; keypoints and intrinsics follow the same geometry.

Drawing is split from applying. JAX's random streams cannot be replayed in
torch, so :func:`draw_augment_params` draws every per-image random number
from an explicit ``torch.Generator`` on the store's device, and the apply
functions take those draws as tensors. A test can then feed both packages
the same draws. The distributions are the JAX package's: angle ~ U(-180,
180), square crop area ratio ~ U(0.6, 1.3) clamped to the image, jitter
factors ~ U(1±0.25) in random order, blur radius ~ U(0, 0.8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dahpe_tpu_torch.ops import shear

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_INTRINSICS_SCALED = np.zeros((3, 3), bool)
_INTRINSICS_SCALED[[0, 1, 0, 1], [0, 1, 2, 2]] = True  # fx, fy, cx, cy
_CONSTANTS: dict[torch.device, dict[str, torch.Tensor]] = {}


def _constants(device: torch.device) -> dict[str, torch.Tensor]:
    """The normalize constants (per channel, CHW-broadcastable) and the
    intrinsics mask on ``device``, copied there once per process: a copy to
    the card waits for the stream, so the hot path never makes one."""
    if device not in _CONSTANTS:
        _CONSTANTS[device] = {
            "mean": torch.as_tensor(IMAGENET_MEAN, device=device)[:, None, None],
            "std": torch.as_tensor(IMAGENET_STD, device=device)[:, None, None],
            "intrinsics_scaled": torch.as_tensor(_INTRINSICS_SCALED, device=device),
        }
    return _CONSTANTS[device]


def draw_augment_params(
    generator: torch.Generator,
    b: int,
    *,
    size: int,
    rotation: float = 180.0,
    scale_range: tuple[float, float] = (0.6, 1.3),
    jitter: float = 0.25,
    blur_range: tuple[float, float] = (0.0, 0.8),
) -> dict[str, torch.Tensor]:
    """Every random number of one batch's augmentation, on the generator's
    device, from one ``torch.rand`` call:

    - ``angle (B,)`` degrees ~ U(-rotation, rotation);
    - ``side (B,)`` square crop side ``clip(round(sqrt(U(scale_range)·size²)),
      1, size)`` and ``offset (B, 2)`` its top-left ``(x, y)``, uniform over
      the positions that keep it inside the ``size²`` crop;
    - ``factors (B, 3)`` brightness / contrast / saturation ~ U(1 ± jitter)
      and ``order (B, 3)`` the random order they apply in;
    - ``radius (B,)`` the blur radius ~ U(blur_range).
    """
    u = torch.rand((b, 11), generator=generator, device=generator.device)
    angle = rotation * (2.0 * u[:, 0] - 1.0)
    lo, hi = scale_range
    side = torch.sqrt((lo + (hi - lo) * u[:, 1]) * float(size * size))
    side = torch.clamp(torch.round(side), 1.0, float(size))
    i = torch.floor(u[:, 2] * (size - side + 1.0))
    j = torch.floor(u[:, 3] * (size - side + 1.0))
    return {
        "angle": angle,
        "side": side,
        "offset": torch.stack([j, i], dim=-1),
        "factors": 1.0 - jitter + 2.0 * jitter * u[:, 4:7],
        "order": torch.argsort(u[:, 7:10], dim=1),
        "radius": blur_range[0] + (blur_range[1] - blur_range[0]) * u[:, 10],
    }


def rotation_slopes(angle_deg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``angle = 90q + r`` with ``|r| <= 45``: the quarter-turns ``q mod 4``
    (int32) and the Paeth slopes ``a = -tan(r/2)``, ``b = sin(r)``."""
    q = torch.round(angle_deg / 90.0)
    r = torch.deg2rad(angle_deg - 90.0 * q)
    return q.to(torch.int32) % 4, -torch.tan(r / 2.0), torch.sin(r)


def _bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``image (B, H, W, C)`` at float ``coords (B, Ho, Wo, 2)`` as
    ``(x, y)``; taps outside the image are 0. The gather oracle of the warp."""
    b, h, w, _ = image.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    rows = torch.arange(b, device=image.device)[:, None, None]

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = image[rows, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return vals * valid[..., None]

    return (
        gather(y0, x0) * (1 - dx) * (1 - dy)
        + gather(y0, x0 + 1) * dx * (1 - dy)
        + gather(y0 + 1, x0) * (1 - dx) * dy
        + gather(y0 + 1, x0 + 1) * dx * dy
    )


def _rotate_shears(
    images: torch.Tensor,
    angle_deg: torch.Tensor,
    slopes: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Rotate square ``(B, H, W, C)`` crops about their centres: the exact
    quarter-turn, then ``ShX(a)·ShY(b)·ShX(a)``, returned channels-first
    ``(B, C, H, W)`` float32 in [0, 255]. One launch of the rotation kernel
    on the card (uint8 input), its plain version on the CPU (uint8 or float).

    ``slopes=(a, b)`` replaces the slopes computed from ``angle_deg``, so a
    test can feed another library's ``tan``/``sin`` values."""
    _, h, w, _ = images.shape
    if h != w:
        raise ValueError(f"shear rotation needs square crops, got {h}x{w}")
    quarter, a, b = rotation_slopes(angle_deg)
    if slopes is not None:
        a, b = slopes
    pad, kmax_a, kmax_b = shear.rotation_geometry(h)
    return shear.rotate3_fused(images, a, b, quarter, pad=pad, kmax_a=kmax_a, kmax_b=kmax_b)


def _interp_matrix(n_out: int, n_in: int, scale: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """Per-image bilinear 1-D interpolation matrices ``W[b, j, x] =
    hat(u_b(j) - x)``, ``u_b(j) = scale_b (j + 0.5) + offset_b - 0.5``:
    the gather's 2-tap weights, with out-of-range taps dropping to zero."""
    j = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    u = scale[:, None] * (j + 0.5) + offset[:, None] - 0.5
    x = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    return torch.clamp(1.0 - torch.abs(u[:, :, None] - x), min=0.0)


def _crop_resize_matmul(image: torch.Tensor, side: torch.Tensor, crop_off: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """Axis-aligned crop + resize of ``(B, C, H, W)`` canvases as two
    interpolation-matrix products; returns ``(B, C, out, out)``."""
    _, _, h, w = image.shape
    s = side / out_size
    wy = _interp_matrix(out_size, h, s, crop_off[:, 1])
    wx = _interp_matrix(out_size, w, s, crop_off[:, 0])
    t = torch.matmul(wy[:, None], image)  # (B, C, out, W)
    return torch.matmul(t, wx[:, None].transpose(-1, -2))


def _warp_keypoints(keypoints: torch.Tensor, intrinsics: torch.Tensor, params: dict,
                    *, size: int, out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's keypoint algebra (``_warp_one``): rotate by -angle
    about the centre, subtract the crop offset, scale by out/side; the
    intrinsics' focal lengths and principal point scale by the same factor."""
    rad = -torch.deg2rad(params["angle"])
    cos, sin = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    c = size / 2.0
    dx, dy = keypoints[..., 0] - c, keypoints[..., 1] - c
    kp = torch.stack([dx * cos + dy * -sin, dx * sin + dy * cos], dim=-1) + c
    factor = (out_size / params["side"])[:, None, None]
    kp = (kp - params["offset"][:, None, :]) * factor
    scaled = _constants(intrinsics.device)["intrinsics_scaled"]
    return kp, torch.where(scaled, intrinsics * factor, intrinsics)


def _color_jitter(image: torch.Tensor, factors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Brightness / contrast / saturation of ``(B, C, H, W)`` in [0, 255], in
    each image's own order. Each op is ``clip(img·f + G·(1 - f))`` with G = 0
    (brightness), the image's mean grey (contrast) or the pixel's grey
    (saturation); the op is picked per image on the device."""
    for step in range(3):
        op = order[:, step]
        f = torch.gather(factors, 1, op[:, None])[:, :, None, None]  # (B, 1, 1, 1)
        gray = (0.299 * image[:, 0] + 0.587 * image[:, 1] + 0.114 * image[:, 2])[:, None]
        mean = gray.mean(dim=(2, 3), keepdim=True)
        op = op[:, None, None, None]
        g = torch.where(op == 2, gray, torch.where(op == 1, mean, torch.zeros_like(mean)))
        image = torch.clamp(image * f + g * (1 - f), 0.0, 255.0)
    return image


def _blur_band(n_out: int, k: torch.Tensor, r: int) -> torch.Tensor:
    """``(B, n_out, n_out + 2r)`` banded matrices applying each image's
    ``2r+1``-tap kernel ``k (B, 2r+1)``."""
    d = (torch.arange(n_out + 2 * r, device=k.device)[None, :]
         - torch.arange(n_out, device=k.device)[:, None])
    taps = k[:, torch.clamp(d, 0, 2 * r)]
    return torch.where((d >= 0) & (d <= 2 * r), taps, torch.zeros_like(taps))


def _gaussian_blur(image: torch.Tensor, radius: torch.Tensor, kernel_radius: int = 2) -> torch.Tensor:
    """PIL-style Gaussian blur of ``(B, C, H, W)`` with per-image radius (its
    sigma): a 5-tap separable kernel (identity below radius 0.01), edge
    padding, applied as two banded matrix products as the JAX package does."""
    sigma = torch.clamp(radius, min=1e-3)[:, None]
    offs = torch.arange(-kernel_radius, kernel_radius + 1, dtype=torch.float32,
                        device=image.device)
    k = torch.exp(-(offs ** 2) / (2 * sigma ** 2))
    k = torch.where(radius[:, None] < 1e-2, (offs == 0).to(torch.float32), k)
    k = k / k.sum(dim=1, keepdim=True)
    _, _, h, w = image.shape
    padded = F.pad(image, (kernel_radius,) * 4, mode="replicate")
    out = torch.matmul(_blur_band(h, k, kernel_radius)[:, None], padded)
    return torch.matmul(out, _blur_band(w, k, kernel_radius)[:, None].transpose(-1, -2))


def augment_batch(
    images: torch.Tensor,
    keypoints: torch.Tensor,
    intrinsics: torch.Tensor,
    params: dict,
    *,
    out_size: int = 256,
    jitter: bool = True,
    blur: bool = True,
    warp: str = "shear",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-time augmentation of a batch of same-sized crops from given draws.

    Args:
      images: ``(B, H, W, 3)`` in [0, 255]: uint8 straight from the store (the
        rotation kernel reads it directly) or float (the CPU's plain path).
      keypoints: ``(B, K, 2)``; intrinsics: ``(B, 3, 3)``.
      params: :func:`draw_augment_params`' dict; an optional ``"slopes"``
        entry ``(a, b)`` overrides the rotation slopes.
      warp: "shear" (quarter-turn + three-shear rotation, then the
        crop-resize products) or "gather" (one per-pixel bilinear gather,
        the numerical oracle; required for non-square crops).

    Returns: normalized images ``(B, out, out, 3)``, keypoints, intrinsics.
    """
    _, h, w, _ = images.shape
    if warp == "shear" and h == w:
        rotated = _rotate_shears(images, params["angle"], params.get("slopes"))
        out = _crop_resize_matmul(rotated, params["side"], params["offset"], out_size)
    elif warp in ("shear", "gather"):
        out = _gather_warp(images.to(torch.float32), params, out_size).permute(0, 3, 1, 2)
    else:
        raise ValueError(f"unknown warp {warp!r}")
    kp, intr = _warp_keypoints(keypoints, intrinsics, params, size=w, out_size=out_size)
    if jitter:
        out = _color_jitter(out, params["factors"], params["order"])
    if blur:
        out = _gaussian_blur(out, params["radius"])
    consts = _constants(out.device)
    out = (out / 255.0 - consts["mean"]) / consts["std"]
    return out.permute(0, 2, 3, 1).contiguous(), kp, intr


def _gather_warp(images: torch.Tensor, params: dict, out_size: int) -> torch.Tensor:
    """Rotation and crop-resize as ONE bilinear resample of ``(B, H, W, C)``
    floats: ``src = R⁻¹ (s·p + offset - centre) + centre``."""
    _, h, w, _ = images.shape
    rad = torch.deg2rad(params["angle"])
    cos, sin = torch.cos(rad)[:, None, None], torch.sin(rad)[:, None, None]
    s = (params["side"] / out_size)[:, None, None]
    ax = torch.arange(out_size, dtype=torch.float32, device=images.device) + 0.5
    px, py = ax[None, None, :], ax[None, :, None]
    ox = params["offset"][:, 0, None, None] - w / 2.0
    oy = params["offset"][:, 1, None, None] - h / 2.0
    src_x = cos * (s * px) - sin * (s * py) + (cos * ox - sin * oy) + w / 2.0 - 0.5
    src_y = sin * (s * px) + cos * (s * py) + (sin * ox + cos * oy) + h / 2.0 - 0.5
    return _bilinear_sample(images, torch.stack([src_x, src_y], dim=-1))


def resize_batch(images: torch.Tensor, keypoints: torch.Tensor, intrinsics: torch.Tensor, *,
                 out_size: int = 256) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval-time square resize + normalize of ``(B, H, W, 3)`` images in
    [0, 255] (the val transform), keypoints and intrinsics scaled to match.

    ``jax.image.resize(method="linear")`` antialiases when it shrinks: its
    triangle kernel widens by the scale factor and is renormalised at the
    edges, which is ``F.interpolate``'s bilinear with ``antialias=True``;
    when it enlarges both are plain edge-clamped bilinear."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(out_size, out_size), mode="bilinear", align_corners=False,
                        antialias=True)
    consts = _constants(out.device)
    out = ((out / 255.0 - consts["mean"]) / consts["std"]).permute(0, 2, 3, 1)
    factor = out_size / images.shape[2]
    scale = torch.where(consts["intrinsics_scaled"], factor, 1.0)
    return out, keypoints * factor, intrinsics * scale
