"""On-device augmentation (port of ``dahpe_tpu/data/device_aug.py``).

So far only the ImageNet normalization constants, which the validation and
serving paths use; the training augmentation is ported with the training
path.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
