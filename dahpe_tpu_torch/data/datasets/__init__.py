"""Dataset definitions: the keypoint base classes and the RHD, H3D and STB
readers."""

from dahpe_tpu_torch.data.datasets.base import Hand21KeypointDataset, KeypointDataset
from dahpe_tpu_torch.data.datasets.h3d import Hand3DStudio, Hand3DStudioAll
from dahpe_tpu_torch.data.datasets.rhd import RenderedHandPose
from dahpe_tpu_torch.data.datasets.stb import STB

__all__ = [
    "Hand21KeypointDataset",
    "KeypointDataset",
    "Hand3DStudio",
    "Hand3DStudioAll",
    "RenderedHandPose",
    "STB",
]
