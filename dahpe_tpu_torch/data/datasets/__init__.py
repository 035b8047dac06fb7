"""Dataset definitions (so far only the 21-joint keypoint groups)."""

from dahpe_tpu_torch.data.datasets.base import Hand21KeypointDataset

__all__ = ["Hand21KeypointDataset"]
