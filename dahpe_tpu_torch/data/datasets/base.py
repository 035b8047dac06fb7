"""Keypoint dataset base classes.

Port of ``dahpe_tpu/data/datasets/base.py`` (reference:
``uda/dataset/keypoint_dataset.py``): sample storage, per-group accuracy
aggregation and the 21-hand-keypoint grouping that every reported metric
uses. Samples come back as numpy dicts; the Gaussian targets are rendered
batched on the device (:func:`dahpe_tpu_torch.data.pipeline.finalize_batch`).

Left out: ``fetch_warped`` raises until ``--host-warp`` (the native host
warp) is ported. ``visualize`` (``--debug``) imports cv2 when it draws.
"""

from __future__ import annotations

import numpy as np


class KeypointDataset:
    """Generic keypoint-detection dataset over a prebuilt sample list."""

    def __init__(
        self,
        root: str,
        num_keypoints: int,
        samples: list,
        transforms=None,
        image_size=(256, 256),
        heatmap_size=(64, 64),
        sigma: int = 2,
        keypoints_group: dict | None = None,
        colored_skeleton: dict | None = None,
    ):
        self.root = root
        self.num_keypoints = num_keypoints
        self.samples = samples
        self.transforms = transforms
        self.image_size = tuple(image_size)
        self.heatmap_size = tuple(heatmap_size)
        self.sigma = sigma
        self.keypoints_group = keypoints_group or {}
        self.colored_skeleton = colored_skeleton or {}

    def __len__(self) -> int:
        return len(self.samples)

    def fetch(self, index: int, rng: np.random.Generator) -> dict:
        """Load and transform one sample with an explicit RNG (thread-safe)."""
        raise NotImplementedError

    def _crop_raw(self, index: int):
        """Decode + dataset-specific crop; returns
        ``(PIL image, keypoint2d, intrinsic_matrix, visible)``."""
        raise NotImplementedError

    def fetch_raw(self, index: int, rng: np.random.Generator, raw_size: int = 288) -> dict:
        """Decode + crop + ONE canonical resize to uint8; augmentation happens
        on the device (:mod:`dahpe_tpu_torch.data.device_aug`). ``rng`` is not
        consumed."""
        from dahpe_tpu_torch.data import transforms as T

        image, keypoint2d, intrinsic_matrix, visible = self._crop_raw(index)
        image, keypoint2d, intrinsic_matrix = T.resize(
            image, raw_size, keypoint2d, intrinsic_matrix
        )
        return {
            "image_u8": np.asarray(image, dtype=np.uint8),
            "keypoint2d": keypoint2d.astype(np.float32),
            "visible": visible,
            "intrinsic_matrix": intrinsic_matrix.astype(np.float32),
        }

    def fetch_warped(self, index: int, rng: np.random.Generator, **kwargs) -> dict:
        """The native fused host warp of the JAX package; not ported yet."""
        raise NotImplementedError(
            "fetch_warped needs the native host warp (--host-warp), not ported yet "
            "(ROADMAP.md queue 1 item 8)"
        )

    def __getitem__(self, index: int) -> dict:
        return self.fetch(index, np.random.default_rng(index))

    def group_accuracy(self, accuracies) -> dict:
        """Average per-joint PCK over the named groups
        (``keypoint_dataset.py:58-71``; entries of -1 are averaged in)."""
        return {
            name: sum(accuracies[i] for i in idxs) / len(idxs)
            for name, idxs in self.keypoints_group.items()
        }

    def visualize(self, image, keypoints, filename: str) -> None:
        """Draw the coloured skeleton over ``image`` (``(H, W, 3)`` uint8
        RGB, ``keypoints (K, 2)`` in its pixels) and write it to ``filename``
        (``keypoint_dataset.py:38-56``)."""
        import cv2

        colors = {
            "yellow": (0, 255, 255),
            "green": (0, 255, 0),
            "blue": (255, 0, 0),
            "purple": (255, 0, 255),
            "red": (0, 0, 255),
            "black": (0, 0, 0),
        }
        img = cv2.cvtColor(np.asarray(image), cv2.COLOR_RGB2BGR).copy()
        for _, (line, color) in self.colored_skeleton.items():
            for i in range(len(line) - 1):
                s, e = keypoints[line[i]], keypoints[line[i + 1]]
                cv2.line(img, (int(s[0]), int(s[1])), (int(e[0]), int(e[1])),
                         color=colors.get(color, (255, 255, 255)), thickness=3)
        for kp in keypoints:
            cv2.circle(img, (int(kp[0]), int(kp[1])), 3, colors["black"], 1)
        cv2.imwrite(filename, img)


class Hand21KeypointDataset(KeypointDataset):
    """21 hand keypoints with the reference's per-finger grouping
    (``keypoint_dataset.py:115-147``). With no arguments it is an empty
    dataset that only carries the grouping (``evaluate.validate`` over a
    device-resident split needs nothing else)."""

    MCP = (1, 5, 9, 13, 17)
    PIP = (2, 6, 10, 14, 18)
    DIP = (3, 7, 11, 15, 19)
    fingertip = (4, 8, 12, 16, 20)
    all = tuple(range(21))
    thumb = (0, 1, 2, 3, 4)
    index_finger = (0, 5, 6, 7, 8)
    middle_finger = (0, 9, 10, 11, 12)
    ring_finger = (0, 13, 14, 15, 16)
    little_finger = (0, 17, 18, 19, 20)

    def __init__(self, root: str = "", samples=(), **kwargs):
        colored_skeleton = {
            "thumb": (self.thumb, "yellow"),
            "index_finger": (self.index_finger, "green"),
            "middle_finger": (self.middle_finger, "blue"),
            "ring_finger": (self.ring_finger, "purple"),
            "little_finger": (self.little_finger, "red"),
        }
        keypoints_group = {
            "MCP": self.MCP,
            "PIP": self.PIP,
            "DIP": self.DIP,
            "fingertip": self.fingertip,
            "all": self.all,
        }
        super().__init__(
            root,
            21,
            list(samples),
            keypoints_group=keypoints_group,
            colored_skeleton=colored_skeleton,
            **kwargs,
        )
