"""STB (Stereo Hand Pose Tracking Benchmark) — real-world target domain.

Parity target: ``uda/dataset/STB.py`` — ``handPara`` .mat labels, depth→color
frame transfer via the SK Rodrigues extrinsics, MCP-first joint reorder and
/10 mm→cm scale, palm→wrist root relocation (x2.1 from joint 9 for labels,
x2.3 from joint 13 for the crop box), fixed SK color intrinsics, 1.6x crop,
and the B1Counting+B1Random test split.

Port of ``dahpe_tpu/data/datasets/stb.py`` (numpy and PIL): the same sample
lists, splits and crops.
"""

from __future__ import annotations

import math
import os
import os.path as osp

import numpy as np
import numpy.linalg as LA
from PIL import Image

from dahpe_tpu_torch.core.geometry import (
    get_bounding_box,
    keypoint2d_to_3d,
    keypoint3d_to_2d,
    scale_box,
)
from dahpe_tpu_torch.data.datasets.base import Hand21KeypointDataset
from dahpe_tpu_torch.data import transforms as T

SK_FX_COLOR = 607.92271
SK_FY_COLOR = 607.88192
SK_TX_COLOR = 314.78337
SK_TY_COLOR = 236.42484

SK_ROT_VEC = [0.00531, -0.01196, 0.00301]
SK_TRANS_VEC = [-24.0381, -0.4563, -1.2326]  # mm

INTRINSIC_MATRIX = np.asarray(
    [[SK_FX_COLOR, 0, SK_TX_COLOR], [0, SK_FY_COLOR, SK_TY_COLOR], [0, 0, 1]]
)

# STB stores joints fingertip-last per finger starting from the little finger;
# reorder to the RHD/MCP-first convention (``STB.py:182``)
HAND_INDEX = [0, 17, 18, 19, 20, 13, 14, 15, 16, 9, 10, 11, 12, 5, 6, 7, 8, 1, 2, 3, 4]

SEQUENCES = [
    "B1Counting", "B1Random", "B2Counting", "B2Random", "B3Counting",
    "B3Random", "B4Counting", "B4Random", "B5Counting", "B5Random",
    "B6Counting", "B6Random",
]


def sk_rot_mx(rot_vec):
    """Rodrigues rotation vector → matrix (``STB.py:19-33``)."""
    theta = LA.norm(rot_vec)
    vector = np.array(rot_vec) * math.sin(theta / 2.0) / theta
    a = math.cos(theta / 2.0)
    b, c, d = -vector
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    )


SK_ROT = sk_rot_mx(SK_ROT_VEC)


def sk_xyz_depth2color(depth_xyz, trans_vec, rot_mx):
    """Depth-camera xyz → color-camera frame (``STB.py:230-236``)."""
    return (depth_xyz - np.asarray(trans_vec)) @ rot_mx


def palm2wrist(pose_xyz, mid_root_id=9, factor=2.1):
    """Relocate the palm root to the wrist (``STB.py:209-221``)."""
    pose_xyz = pose_xyz.copy()
    pose_xyz[:, 0, :] = pose_xyz[:, mid_root_id, :] + factor * (
        pose_xyz[:, 0, :] - pose_xyz[:, mid_root_id, :]
    )
    return pose_xyz


class STB(Hand21KeypointDataset):
    def __init__(self, root, split="train", task="noobject", transforms=None, **kwargs):
        root = os.path.join(root, "STB")
        assert split in ["train", "test", "all"]
        self.split = split
        if split == "train":
            image_list = SEQUENCES[2:]
        elif split == "test":
            image_list = SEQUENCES[:2]
        else:
            image_list = SEQUENCES
        samples = self.get_samples(root, image_list)
        super().__init__(root, samples, transforms=transforms, **kwargs)

    @staticmethod
    def get_samples(root, image_list, image_prefix="SK_color"):
        import scipy.io as sio

        ann_dir = os.path.join(root, "labels")
        samples = []
        for seq in image_list:
            mat_gt = sio.loadmat(
                os.path.join(ann_dir, seq + "_" + image_prefix[:2] + ".mat")
            )
            pose = mat_gt["handPara"].transpose((2, 1, 0))  # N x 21 x 3, mm
            pose = sk_xyz_depth2color(pose, SK_TRANS_VEC, SK_ROT)
            pose = pose[:, HAND_INDEX, :] / 10.0
            pose_label = palm2wrist(pose, mid_root_id=9, factor=2.1)
            pose_box = palm2wrist(pose, mid_root_id=13, factor=2.3)

            for i in range(pose_label.shape[0]):
                samples.append(
                    {
                        "name": osp.join(seq, f"{image_prefix}_{i}.png"),
                        "keypoint2d": keypoint3d_to_2d(pose_label[i], INTRINSIC_MATRIX),
                        "keypoint2d2": keypoint3d_to_2d(pose_box[i], INTRINSIC_MATRIX),
                        "keypoint3d": pose_label[i],
                        "intrinsic_matrix": INTRINSIC_MATRIX,
                    }
                )
        return samples

    def fetch(self, index, rng: np.random.Generator):
        sample = self.samples[index]
        image_path = os.path.join(self.root, sample["name"])
        image = Image.open(image_path)

        keypoint3d_camera = np.array(sample["keypoint3d"])
        keypoint2d = np.array(sample["keypoint2d"])
        keypoint2d2 = np.array(sample["keypoint2d2"])  # crop box uses this
        intrinsic_matrix = np.array(sample["intrinsic_matrix"])
        zc = keypoint3d_camera[:, 2]

        # 1.6x square crop around the palm2wrist0 box (``STB.py:119-123``)
        bounding_box = get_bounding_box(keypoint2d2)
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.6)
        image, keypoint2d = T.crop(
            image, upper, left, lower - upper, right - left, keypoint2d
        )

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
            "visible": np.ones((self.num_keypoints,), np.float32),
            "keypoint3d": keypoint3d_n.astype(np.float32),
            "z": keypoint3d_camera[:, 2].astype(np.float32),
            "intrinsic_matrix": intrinsic_matrix.astype(np.float32),
            "image_path": image_path,
        }
        if "image_ema" in data:
            out["image_ema"] = np.asarray(data["image_ema"], dtype=np.float32)
        return out

    def _crop_raw(self, index: int):
        """Decode + 1.6x square crop around the palm2wrist0 box."""
        sample = self.samples[index]
        image = Image.open(os.path.join(self.root, sample["name"]))
        keypoint2d = np.array(sample["keypoint2d"])
        keypoint2d2 = np.array(sample["keypoint2d2"])
        intrinsic_matrix = np.array(sample["intrinsic_matrix"], np.float32)
        bounding_box = get_bounding_box(keypoint2d2)
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.6)
        image, keypoint2d = T.crop(
            image, upper, left, lower - upper, right - left, keypoint2d
        )
        visible = np.ones((self.num_keypoints,), np.float32)
        return image, keypoint2d, intrinsic_matrix, visible
