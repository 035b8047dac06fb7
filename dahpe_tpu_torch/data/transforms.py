"""Host-side keypoint-aware transforms (PIL), reference-exact.

Behavioral parity with ``uda/dataset/keypoint_detection.py``: every geometric
transform co-updates ``keypoint2d`` (and ``intrinsic_matrix`` where scaling is
involved). Randomness comes from an explicit ``numpy.random.Generator`` passed
at call time instead of process-global ``random`` state, so workers are
reproducible and seeds shard cleanly.

This is the exactness path (validation + golden tests + optional train
parity). The throughput path is :mod:`dahpe_tpu_torch.data.device_aug`, which fuses
rotation/crop/resize into one on-device affine warp.

Port of ``dahpe_tpu/data/transforms.py`` (numpy and PIL, unchanged).
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageFilter

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------- functions

def resize(image, size, keypoint2d, intrinsic_matrix):
    """Square resize; scales keypoints and intrinsics (``:37-55``)."""
    width, height = image.size
    assert width == height, "resize expects a square crop"
    factor = float(size) / float(width)
    image = image.resize((size, size), Image.BILINEAR)
    keypoint2d = np.copy(keypoint2d) * factor
    intrinsic_matrix = np.copy(intrinsic_matrix)
    intrinsic_matrix[0][0] *= factor
    intrinsic_matrix[0][2] *= factor
    intrinsic_matrix[1][1] *= factor
    intrinsic_matrix[1][2] *= factor
    return image, keypoint2d, intrinsic_matrix


def crop(image, top, left, height, width, keypoint2d):
    """PIL crop; shifts keypoints (``:58-63``)."""
    image = image.crop((left, top, left + width, top + height))
    keypoint2d = np.copy(keypoint2d)
    keypoint2d[:, 0] -= left
    keypoint2d[:, 1] -= top
    return image, keypoint2d


def resized_crop(image, top, left, height, width, size, keypoint2d, intrinsic_matrix):
    image, keypoint2d = crop(image, top, left, height, width, keypoint2d)
    return resize(image, size, keypoint2d, intrinsic_matrix)


def hflip(image, keypoint2d):
    """Horizontal flip; ``x -> width - 1 - x`` (``:108-113``)."""
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    keypoint2d = np.copy(keypoint2d)
    keypoint2d[:, 0] = image.size[0] - 1.0 - keypoint2d[:, 0]
    return image, keypoint2d


def rotate(image, angle, keypoint2d):
    """PIL rotate around the center; keypoints rotated by -angle rad
    (``:116-131``)."""
    image = image.rotate(angle)
    rad = -np.deg2rad(angle)
    rot = np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]])
    width, height = image.size
    kp = np.copy(keypoint2d)
    kp[:, 0] -= width / 2
    kp[:, 1] -= height / 2
    kp = (rot @ kp.T).T
    kp[:, 0] += width / 2
    kp[:, 1] += height / 2
    return image, kp


def to_normalized_array(image) -> np.ndarray:
    """ToTensor + ImageNet Normalize, emitted HWC float32 (NHWC pipeline)."""
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def denormalize(arr: np.ndarray) -> np.ndarray:
    """Inverse of the ImageNet normalization (``utils/__init__.py:51-69``)."""
    return np.clip(arr * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


# ------------------------------------------------------------------ classes

class Compose:
    """Chain transforms; snapshots a pre-photometric ``image_ema`` weak view
    right after RandomResizedCrop, as the reference does (``:161-181``)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, rng: np.random.Generator, **kwargs):
        for t in self.transforms:
            image, kwargs = t(image, rng=rng, **kwargs)
            if isinstance(t, RandomResizedCrop):
                kwargs["image_ema"] = to_normalized_array(image)
        return image, kwargs


class Resize:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, image, keypoint2d, intrinsic_matrix, rng=None, **kwargs):
        image, keypoint2d, intrinsic_matrix = resize(
            image, self.size, keypoint2d, intrinsic_matrix
        )
        kwargs.update(keypoint2d=keypoint2d, intrinsic_matrix=intrinsic_matrix)
        return image, kwargs


class RandomRotation:
    def __init__(self, degrees):
        if isinstance(degrees, (int, float)):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def __call__(self, image, keypoint2d, rng: np.random.Generator, **kwargs):
        angle = rng.uniform(self.degrees[0], self.degrees[1])
        image, keypoint2d = rotate(image, angle, keypoint2d)
        kwargs.update(keypoint2d=keypoint2d)
        return image, kwargs


class RandomResizedCrop:
    """Square random-area crop + resize (aspect ratio fixed to 1, scale
    default (0.6, 1.3), whole-image fallback — ``:299-365``)."""

    def __init__(self, size: int, scale=(0.6, 1.3)):
        self.size = size
        self.scale = scale

    def get_params(self, image, rng: np.random.Generator):
        width, height = image.size
        area = height * width
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            w = int(round(math.sqrt(target_area)))
            h = int(round(math.sqrt(target_area)))
            if 0 < w <= width and 0 < h <= height:
                i = int(rng.integers(0, height - h + 1))
                j = int(rng.integers(0, width - w + 1))
                return i, j, h, w
        return 0, 0, height, width

    def __call__(self, image, keypoint2d, intrinsic_matrix, rng, **kwargs):
        i, j, h, w = self.get_params(image, rng)
        image, keypoint2d, intrinsic_matrix = resized_crop(
            image, i, j, h, w, self.size, keypoint2d, intrinsic_matrix
        )
        kwargs.update(keypoint2d=keypoint2d, intrinsic_matrix=intrinsic_matrix)
        return image, kwargs


class ColorJitter:
    """Brightness/contrast/saturation jitter with torchvision semantics:
    random order, factors uniform in [max(0, 1-v), 1+v]."""

    def __init__(self, brightness=0.25, contrast=0.25, saturation=0.25):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _blend(a, b, factor):
        return np.clip(a * factor + b * (1.0 - factor), 0, 255)

    def __call__(self, image, rng: np.random.Generator, **kwargs):
        arr = np.asarray(image, dtype=np.float32)
        ops = []
        for name, v in (
            ("brightness", self.brightness),
            ("contrast", self.contrast),
            ("saturation", self.saturation),
        ):
            if v and v > 0:
                f = rng.uniform(max(0.0, 1.0 - v), 1.0 + v)
                ops.append((name, f))
        order = rng.permutation(len(ops))
        for k in order:
            name, f = ops[k]
            if name == "brightness":
                arr = self._blend(arr, np.zeros_like(arr), f)
            elif name == "contrast":
                gray = (
                    0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
                ).mean()
                arr = self._blend(arr, np.full_like(arr, gray), f)
            else:  # saturation
                gray = (
                    0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
                )[..., None]
                arr = self._blend(arr, np.broadcast_to(gray, arr.shape), f)
        return Image.fromarray(arr.astype(np.uint8)), kwargs


class GaussianBlur:
    def __init__(self, low=0.0, high=0.8):
        self.low = low
        self.high = high

    def __call__(self, image, rng: np.random.Generator, **kwargs):
        radius = rng.uniform(self.low, self.high)
        return image.filter(ImageFilter.GaussianBlur(radius)), kwargs


class ToNormalizedArray:
    """Terminal transform: PIL -> normalized float32 HWC."""

    def __call__(self, image, rng=None, **kwargs):
        return to_normalized_array(image), kwargs


def train_transform(image_size=256, rotation=180, resize_scale=(0.6, 1.3)):
    """The reference's train pipeline (``train1.py:56-63``)."""
    return Compose(
        [
            RandomRotation(rotation),
            RandomResizedCrop(image_size, scale=resize_scale),
            ColorJitter(0.25, 0.25, 0.25),
            GaussianBlur(),
            ToNormalizedArray(),
        ]
    )


def val_transform(image_size=256):
    """The reference's val pipeline (``train1.py:66-70``)."""
    return Compose([Resize(image_size), ToNormalizedArray()])
