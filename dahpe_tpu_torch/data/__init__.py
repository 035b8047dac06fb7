"""Data: the device-resident store and its eval loader, the normalization
constants and the keypoint groups."""

from dahpe_tpu_torch.data.datasets import Hand21KeypointDataset
from dahpe_tpu_torch.data.device_store import DeviceDataStore

__all__ = ["DeviceDataStore", "Hand21KeypointDataset"]
