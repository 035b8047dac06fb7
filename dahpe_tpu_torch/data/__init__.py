"""Data: the dataset readers and their registry, keypoint-aware host
transforms, the decoded-crop cache, the host input pipeline, and the
device-resident store with its on-device augmentation.

The registry mirrors the reference's module-reflection lookup
(``uda/dataset/__init__.py``, ``train1.py:73,82,597-600``) as the JAX
package's ``dahpe_tpu/data/__init__.py`` does.
"""

from dahpe_tpu_torch.data.cache import DecodedCache
from dahpe_tpu_torch.data.datasets import (
    STB,
    Hand3DStudio,
    Hand3DStudioAll,
    Hand21KeypointDataset,
    KeypointDataset,
    RenderedHandPose,
)
from dahpe_tpu_torch.data.device_store import DeviceDataStore
from dahpe_tpu_torch.data.pipeline import BatchLoader, ForeverIterator, finalize_batch
from dahpe_tpu_torch.data.synthetic import SyntheticHandsSource, SyntheticHandsTarget

DATASETS = {
    "RenderedHandPose": RenderedHandPose,
    "Hand3DStudio": Hand3DStudio,
    "Hand3DStudioAll": Hand3DStudioAll,
    "STB": STB,
    # asset-free procedural domains with a controlled photometric shift
    # (data/synthetic.py): the CLI drills
    "SyntheticHandsSource": SyntheticHandsSource,
    "SyntheticHandsTarget": SyntheticHandsTarget,
}


def check_exists(root, name: str) -> None:
    """Fail fast on a missing dataset root (``utils/_util.py:40-46`` role):
    there is no automatic download, so a wrong root must surface here and
    not as a FileNotFoundError deep inside a parser."""
    import os

    if root is None or not os.path.isdir(root):
        raise FileNotFoundError(
            f"Dataset root {root!r} for {name} does not exist. There is no "
            f"automatic download: place the dataset there (see the reference "
            f"README for sources) or pass the correct root."
        )


def get_dataset(name: str, **kwargs):
    try:
        cls = DATASETS[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; choices: {sorted(DATASETS)}") from None
    if getattr(cls, "requires_root", True):
        check_exists(kwargs.get("root"), name)
    return cls(**kwargs)


__all__ = [
    "DATASETS",
    "get_dataset",
    "check_exists",
    "KeypointDataset",
    "Hand21KeypointDataset",
    "RenderedHandPose",
    "Hand3DStudio",
    "Hand3DStudioAll",
    "STB",
    "SyntheticHandsSource",
    "SyntheticHandsTarget",
    "BatchLoader",
    "DecodedCache",
    "DeviceDataStore",
    "ForeverIterator",
    "finalize_batch",
]
