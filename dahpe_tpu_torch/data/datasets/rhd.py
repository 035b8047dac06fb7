"""RHD (Rendered Hand Pose) — the synthetic source domain.

Parity target: ``uda/dataset/rendered_hand_pose.py`` — per-image two-hand
splitting with joint reindexing, visibility/crop-size/overlap filters, 1.5x
square crop around the keypoints, and left→right hand flipping.

Port of ``dahpe_tpu/data/datasets/rhd.py`` (numpy and PIL): the same sample
lists, splits and crops.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

from dahpe_tpu_torch.core.geometry import (
    box_area,
    box_intersection,
    get_bounding_box,
    keypoint2d_to_3d,
    scale_box,
)
from dahpe_tpu_torch.data.datasets.base import Hand21KeypointDataset
from dahpe_tpu_torch.data import transforms as T

# RHD stores left hand joints 0..20, right 21..41, fingertip-first per finger;
# this reindex makes both MCP-first (``rendered_hand_pose.py:128-129``)
LEFT_HAND_INDEX = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13, 20, 19, 18, 17]
RIGHT_HAND_INDEX = [i + 21 for i in LEFT_HAND_INDEX]


class RenderedHandPose(Hand21KeypointDataset):
    def __init__(self, root, split="train", task="all", transforms=None, **kwargs):
        root = os.path.join(root, "RHD_published_v2")
        assert split in ["train", "test", "all"]
        self.split = split
        if split == "all":
            samples = self.get_samples(root, "train") + self.get_samples(root, "test")
        else:
            samples = self.get_samples(root, split)
        super().__init__(root, samples, transforms=transforms, **kwargs)

    @staticmethod
    def get_samples(root, task, min_size=64):
        """Build the two-hands-per-image sample list with the reference's
        filters (``rendered_hand_pose.py:118-174``): scaled box side > 64,
        > 16 visible joints, <30% overlap with the other hand's box."""
        set_name = "training" if task == "train" else "evaluation"
        with open(
            os.path.join(root, set_name, f"anno_{set_name}.pickle"), "rb"
        ) as fi:
            anno_all = pickle.load(fi)

        samples = []
        w, h = 320, 320
        for sample_id, anno in sorted(anno_all.items()):
            image_name = os.path.join(set_name, "color", "%.5d.png" % sample_id)
            keypoint2d = anno["uv_vis"][:, :2]
            keypoint3d = anno["xyz"]
            intrinsic_matrix = anno["K"]
            visible = anno["uv_vis"][:, 2]

            for idx, is_left in ((LEFT_HAND_INDEX, True), (RIGHT_HAND_INDEX, False)):
                other = RIGHT_HAND_INDEX if is_left else LEFT_HAND_INDEX
                kp = keypoint2d[idx]
                box = get_bounding_box(kp)
                other_box = get_bounding_box(keypoint2d[other])
                scaled = scale_box(box, w, h, 1.5)
                left, upper, right, lower = scaled
                size = max(right - left, lower - upper)
                overlap = box_area(*box_intersection(scaled, other_box)) / box_area(
                    *scaled
                )
                if size > min_size and np.sum(visible[idx]) > 16 and overlap < 0.3:
                    samples.append(
                        {
                            "name": image_name,
                            "keypoint2d": kp,
                            "visible": visible[idx],
                            "keypoint3d": keypoint3d[idx],
                            "intrinsic_matrix": intrinsic_matrix,
                            "left": is_left,
                        }
                    )
        return samples

    def fetch(self, index, rng: np.random.Generator):
        """Load, 1.5x-square-crop around the hand, flip left hands to right,
        apply transforms (``rendered_hand_pose.py:50-116``). Returns a numpy
        dict; Gaussian targets are rendered on device by the pipeline."""
        sample = self.samples[index]
        image_path = os.path.join(self.root, sample["name"])
        image = Image.open(image_path)

        keypoint3d_camera = np.array(sample["keypoint3d"])
        keypoint2d = np.array(sample["keypoint2d"])
        intrinsic_matrix = np.array(sample["intrinsic_matrix"])
        zc = keypoint3d_camera[:, 2]

        bounding_box = get_bounding_box(keypoint2d)
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.5)
        image, keypoint2d = T.crop(
            image, upper, left, lower - upper, right - left, keypoint2d
        )
        if sample["left"] is False:
            image, keypoint2d = T.hflip(image, keypoint2d)

        image, data = self.transforms(
            image, rng=rng, keypoint2d=keypoint2d, intrinsic_matrix=intrinsic_matrix
        )
        keypoint2d = data["keypoint2d"]
        intrinsic_matrix = data["intrinsic_matrix"]
        keypoint3d_camera = keypoint2d_to_3d(keypoint2d, intrinsic_matrix, zc)

        visible = np.array(sample["visible"], dtype=np.float32)

        # MCP-9-centered, wrist-bone-normalized 3D (``:88-101``)
        keypoint3d_n = keypoint3d_camera - keypoint3d_camera[9:10, :]
        norm_scale = np.sqrt(np.sum(keypoint3d_n[0, :] ** 2))
        keypoint3d_n = keypoint3d_n / norm_scale

        return {
            "image": np.asarray(image, dtype=np.float32),
            "keypoint2d": keypoint2d.astype(np.float32),
            "visible": visible,
            "keypoint3d": keypoint3d_n.astype(np.float32),
            "z": keypoint3d_n[:, 2].astype(np.float32),
            "intrinsic_matrix": intrinsic_matrix.astype(np.float32),
            "image_path": image_path,
        }

    def _crop_raw(self, index: int):
        """Decode + square crop + flip; returns the native-size uint8 crop."""
        sample = self.samples[index]
        image = Image.open(os.path.join(self.root, sample["name"]))
        keypoint2d = np.array(sample["keypoint2d"])
        intrinsic_matrix = np.array(sample["intrinsic_matrix"], np.float32)
        bounding_box = get_bounding_box(keypoint2d)
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.5)
        image, keypoint2d = T.crop(
            image, upper, left, lower - upper, right - left, keypoint2d
        )
        if sample["left"] is False:
            image, keypoint2d = T.hflip(image, keypoint2d)
        visible = np.array(sample["visible"], dtype=np.float32)
        return image, keypoint2d, intrinsic_matrix, visible
