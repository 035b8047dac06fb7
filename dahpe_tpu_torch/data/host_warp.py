"""Host-side fused augmentation on the native C++ warp (``--host-warp``).

Port of ``dahpe_tpu/data/host_warp.py``: the augmentation semantics of the
device path (:mod:`dahpe_tpu_torch.data.device_aug`) and of the
reference's PIL chain (``train1.py:56-63``), with the geometric chain
(rotation + square random-resized crop + resize) as ONE bilinear resample
and the photometrics after it, all in one call of the native library
(``utils/native.py:fused_augment``). The Gaussian targets are rendered on
the device (``pipeline.finalize_batch``).

The draws come from a ``numpy.random.Generator`` in the JAX package's order,
so equal seeds give the JAX package's batches. There is no numpy fallback
on this path: :func:`augment_plain` is the numpy version of the library
call, for the tests.
"""

from __future__ import annotations

import math

import numpy as np

from dahpe_tpu_torch.utils import native

IMAGENET_MEAN = native.IMAGENET_MEAN
IMAGENET_STD = native.IMAGENET_STD
_RAW_MEAN = np.zeros(3, np.float32)
_RAW_STD = np.full(3, 1.0 / 255.0, np.float32)  # the warp then emits raw 0..255 floats


def sample_affine(rng: np.random.Generator, h: int, w: int, out_size: int, rotation: float,
                  scale_range: tuple[float, float]):
    """Draw the rotation and the random-resized crop; returns the fused
    output→source map ``(mat, off)`` and the keypoint side's pieces
    ``(angle, side, crop_off)`` (the algebra of ``device_aug``)."""
    angle = rng.uniform(-rotation, rotation)
    rad = np.deg2rad(angle)
    side = math.sqrt(rng.uniform(*scale_range) * float(h * w))
    side = float(np.clip(round(side), 1.0, min(h, w)))
    i = float(np.floor(rng.uniform() * (h - side + 1.0)))
    j = float(np.floor(rng.uniform() * (w - side + 1.0)))

    s = side / out_size
    cos, sin = np.cos(rad), np.sin(rad)
    rot_inv = np.asarray([[cos, -sin], [sin, cos]], np.float32)
    center = np.asarray([w / 2.0, h / 2.0], np.float32)
    mat = rot_inv @ np.asarray([[s, 0.0], [0.0, s]], np.float32)
    off = rot_inv @ (np.asarray([j, i], np.float32) - center) + center
    return mat, off, angle, side, np.asarray([j, i], np.float32)


def _apply_jitter_op(img: np.ndarray, op: int, f: float) -> np.ndarray:
    if op == 0:  # brightness
        return np.clip(img * f, 0, 255)
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    if op == 1:  # contrast: blend with the mean gray
        return np.clip(img * f + gray.mean() * (1 - f), 0, 255)
    return np.clip(img * f + gray[..., None] * (1 - f), 0, 255)  # saturation


def _gaussian_blur_sigma(img: np.ndarray, sigma: float) -> np.ndarray:
    r = 2
    offs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(offs**2) / (2 * max(sigma, 1e-3) ** 2))
    k /= k.sum()
    pad = np.pad(img, ((r, r), (0, 0), (0, 0)), mode="edge")
    img = sum(k[t] * pad[t : t + img.shape[0]] for t in range(2 * r + 1))
    pad = np.pad(img, ((0, 0), (r, r), (0, 0)), mode="edge")
    img = sum(k[t] * pad[:, t : t + img.shape[1]] for t in range(2 * r + 1))
    return img


def augment_plain(src: np.ndarray, mat: np.ndarray, off: np.ndarray, out_size: int,
                  jitter_ops: np.ndarray, jitter_factors: np.ndarray,
                  blur_sigma: float) -> np.ndarray:
    """numpy version of ``native.fused_augment`` (the JAX package's
    fallback): the warp in raw pixel values, each jitter op with its factor
    in order, the blur, the normalisation."""
    img = native.affine_warp_plain(src, mat, off, (out_size, out_size), mean=_RAW_MEAN,
                                   std=_RAW_STD, border_mode=0)
    for op, f in zip(jitter_ops, jitter_factors):
        img = _apply_jitter_op(img, int(op), float(f))
    if blur_sigma > 1e-2:
        img = _gaussian_blur_sigma(img, blur_sigma)
    return ((img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def warp_augment(image_u8: np.ndarray, keypoint2d: np.ndarray, intrinsic_matrix: np.ndarray,
                 rng: np.random.Generator, *, out_size: int = 256, rotation: float = 180.0,
                 scale_range: tuple[float, float] = (0.6, 1.3), jitter: float = 0.25,
                 blur: float = 0.8):
    """One sample: the fused native warp → jitter → blur → normalize.

    Returns ``(image (out, out, 3) float32 normalized, keypoint2d,
    intrinsics)``; the keypoints and intrinsics follow the rotation, the
    crop and the scale."""
    h, w, _ = image_u8.shape
    mat, off, angle, side, crop_off = sample_affine(rng, h, w, out_size, rotation, scale_range)
    if jitter:
        jitter_factors = rng.uniform(1.0 - jitter, 1.0 + jitter, size=3)
        jitter_ops = rng.permutation(3)
    else:
        jitter_factors = np.zeros(0)
        jitter_ops = np.zeros(0, np.int32)
    blur_sigma = float(rng.uniform(0.0, blur)) if blur else 0.0
    img = native.fused_augment(image_u8, mat, off, out_size, jitter_ops,
                               jitter_factors[jitter_ops] if jitter else jitter_factors,
                               blur_sigma)

    # keypoints: rotate by -angle about the centre, shift by the crop, scale
    rad = -np.deg2rad(angle)
    rot = np.asarray([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]], np.float32)
    center = np.asarray([w / 2.0, h / 2.0], np.float32)
    kp = (keypoint2d - center) @ rot.T + center
    factor = out_size / side
    kp = (kp - crop_off) * factor

    intr = intrinsic_matrix.copy()
    intr[0, 0] *= factor
    intr[0, 2] *= factor
    intr[1, 1] *= factor
    intr[1, 2] *= factor
    return img, kp.astype(np.float32), intr
