"""Camera geometry and crop-box math.

Numpy/jnp-agnostic ports of ``uda/dataset/util.py:72-143``. These run both on
host (dataset index building, Python scalars) and on device (batched jnp).

Port of ``dahpe_tpu/core/geometry.py`` (numpy, unchanged).
"""

from __future__ import annotations

import numpy as np


def keypoint2d_to_3d(keypoint2d, intrinsic_matrix, z):
    """Back-project 2D keypoints to camera-space 3D (``util.py:72-76``).

    Host-side (numpy) — used while building dataset samples.
    Args: keypoint2d ``(K, 2)``, intrinsic_matrix ``(3, 3)``, z ``(K,)``.
    """
    ones = np.ones((keypoint2d.shape[0], 1), dtype=np.asarray(keypoint2d).dtype)
    uv1 = np.concatenate([keypoint2d, ones], axis=1).T * z  # (3, K)
    xyz = (np.linalg.inv(intrinsic_matrix) @ uv1).T
    return xyz


def keypoint3d_to_2d(keypoint3d, intrinsic_matrix):
    """Pinhole projection (``util.py:79-83``). keypoint3d ``(K, 3)``."""
    uvz = (intrinsic_matrix @ keypoint3d.T).T
    return uvz[:, :2] / uvz[:, 2:3]


def get_bounding_box(keypoint2d):
    """(left, upper, right, lower) box of keypoints (``util.py:115-121``)."""
    return (
        float(np.min(keypoint2d[:, 0])),
        float(np.min(keypoint2d[:, 1])),
        float(np.max(keypoint2d[:, 0])),
        float(np.max(keypoint2d[:, 1])),
    )


def scale_box(box, image_width, image_height, scale):
    """Square crop box of side ``scale * max(w, h)``, clamped to the image.

    Exact port of ``util.py:86-112`` including banker's rounding via Python
    ``round`` and the side-1 pixel conventions, so crop boxes (and therefore
    any downstream golden values) match the reference bit-for-bit.
    """
    left, upper, right, lower = box
    center_x, center_y = (left + right) / 2, (upper + lower) / 2
    w, h = right - left, lower - upper
    side_with = min(round(scale * max(w, h)), min(image_width, image_height))
    left = round(center_x - side_with / 2)
    right = left + side_with - 1
    upper = round(center_y - side_with / 2)
    lower = upper + side_with - 1
    if left < 0:
        left = 0
        right = side_with - 1
    if right >= image_width:
        right = image_width - 1
        left = image_width - side_with
    if upper < 0:
        upper = 0
        lower = side_with - 1
    if lower >= image_height:
        lower = image_height - 1
        upper = image_height - side_with
    return left, upper, right, lower


def box_area(left, upper, right, lower):
    """Inclusive-pixel box area (``util.py:136-137``)."""
    return max(right - left + 1, 0) * max(lower - upper + 1, 0)


def box_intersection(box_a, box_b):
    """Intersection box (``util.py:140-143``)."""
    la, ua, ra, wa = box_a
    lb, ub, rb, wb = box_b
    return max(la, lb), max(ua, ub), min(ra, rb), min(wa, wb)
