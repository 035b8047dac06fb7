"""Hand-3d-Studio (H3D) — real-world target domain (pre-cropped images).

Parity target: ``uda/dataset/hand_3d_studio.py`` — annotation.json, the
with/without-object task filter, and the deterministic seed-42 split with
test = min(20%, 3200) samples.

Port of ``dahpe_tpu/data/datasets/h3d.py`` (numpy and PIL): the same sample
lists, splits and crops.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
from PIL import Image

from dahpe_tpu_torch.core.geometry import keypoint2d_to_3d
from dahpe_tpu_torch.data.datasets.base import Hand21KeypointDataset


class Hand3DStudio(Hand21KeypointDataset):
    def __init__(self, root, split="train", task="noobject", transforms=None, **kwargs):
        assert split in ["train", "test", "all"]
        assert task in ["noobject", "object", "all"]
        self.split = split
        self.task = task

        root = os.path.join(root, "H3D_crop")
        with open(os.path.join(root, "annotation.json")) as f:
            samples = list(json.load(f))
        if task == "noobject":
            samples = [s for s in samples if int(s["without_object"]) == 1]
        elif task == "object":
            samples = [s for s in samples if int(s["without_object"]) == 0]

        # the reference fixes the split with the stdlib RNG at seed 42
        # (``hand_3d_studio.py:68-75``); reproduce exactly
        random.seed(42)
        random.shuffle(samples)
        n_split = min(int(len(samples) * 0.2), 3200)
        if split == "train":
            samples = samples[n_split:]
        elif split == "test":
            samples = samples[:n_split]

        super().__init__(root, samples, transforms=transforms, **kwargs)

    def fetch(self, index, rng: np.random.Generator):
        sample = self.samples[index]
        image_path = os.path.join(self.root, sample["name"])
        image = Image.open(image_path)

        keypoint3d_camera = np.array(sample["keypoint3d"])
        keypoint2d = np.array(sample["keypoint2d"])
        intrinsic_matrix = np.array(sample["intrinsic_matrix"])
        zc = keypoint3d_camera[:, 2]

        image, data = self.transforms(
            image, rng=rng, keypoint2d=keypoint2d, intrinsic_matrix=intrinsic_matrix
        )
        keypoint2d = data["keypoint2d"]
        intrinsic_matrix = data["intrinsic_matrix"]
        keypoint3d_camera = keypoint2d_to_3d(keypoint2d, intrinsic_matrix, zc)

        keypoint3d_n = keypoint3d_camera - keypoint3d_camera[9:10, :]
        keypoint3d_n = keypoint3d_n / np.sqrt(np.sum(keypoint3d_n[0, :] ** 2))

        out = {
            "image": np.asarray(image, dtype=np.float32),
            "keypoint2d": keypoint2d.astype(np.float32),
            # H3D reports all joints visible (``hand_3d_studio.py:99``)
            "visible": np.ones((self.num_keypoints,), np.float32),
            "keypoint3d": keypoint3d_n.astype(np.float32),
            "intrinsic_matrix": intrinsic_matrix.astype(np.float32),
            "image_path": image_path,
        }
        if "image_ema" in data:
            out["image_ema"] = np.asarray(data["image_ema"], dtype=np.float32)
        return out


    def _crop_raw(self, index: int):
        """H3D images are pre-cropped; no geometry on the host."""
        sample = self.samples[index]
        image = Image.open(os.path.join(self.root, sample["name"]))
        keypoint2d = np.array(sample["keypoint2d"])
        intrinsic_matrix = np.array(sample["intrinsic_matrix"], np.float32)
        visible = np.ones((self.num_keypoints,), np.float32)
        return image, keypoint2d, intrinsic_matrix, visible


class Hand3DStudioAll(Hand3DStudio):
    """task='all' variant (``hand_3d_studio.py:121-127``)."""

    def __init__(self, root, task="all", **kwargs):
        super().__init__(root, task=task, **kwargs)
