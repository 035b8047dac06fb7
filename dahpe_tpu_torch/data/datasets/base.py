"""Keypoint groups (port of part of ``dahpe_tpu/data/datasets/base.py``).

So far only the 21-hand-keypoint grouping that every reported metric uses
and the per-group accuracy average that ``evaluate.validate`` reads; the
dataset readers are ported with the host data path.
"""

from __future__ import annotations


class Hand21KeypointDataset:
    """The reference's 21 hand keypoints and their per-finger groups
    (``keypoint_dataset.py:115-147``)."""

    num_keypoints = 21
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

    def __init__(self):
        self.keypoints_group = {
            "MCP": self.MCP,
            "PIP": self.PIP,
            "DIP": self.DIP,
            "fingertip": self.fingertip,
            "all": self.all,
        }

    def group_accuracy(self, accuracies) -> dict:
        """Average per-joint PCK over the named groups, as the reference's
        ``keypoint_dataset.py:58-71`` (entries of -1 are averaged in)."""
        return {
            name: sum(accuracies[i] for i in idxs) / len(idxs)
            for name, idxs in self.keypoints_group.items()
        }
