"""Debug visualisation: JET heatmap overlays.

Port of ``dahpe_tpu/utils/visualize.py`` (the reference's
``uda/dataset/util.py:124-133``). Host-side numpy and cv2 only; cv2 is
imported when a drawing is made, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


def visualize_heatmap(image, heatmaps, filename_fmt: str) -> None:
    """Write one JET-colormap overlay per joint.

    Args:
      image: ``(H, W, 3)`` uint8 RGB (any size; resized to the heatmap).
      heatmaps: ``(h, w, K)`` float in [0, 1].
      filename_fmt: a format string with one ``{}`` slot for the joint index.
    """
    import cv2

    image = cv2.cvtColor(np.asarray(image), cv2.COLOR_RGB2BGR).copy()
    h, w, k = heatmaps.shape
    resized = cv2.resize(image, (int(w), int(h)))
    hm = np.clip(np.asarray(heatmaps) * 255.0, 0, 255).astype(np.uint8)
    for j in range(k):
        colored = cv2.applyColorMap(hm[..., j], cv2.COLORMAP_JET)
        cv2.imwrite(filename_fmt.format(j), colored * 0.7 + resized * 0.3)
