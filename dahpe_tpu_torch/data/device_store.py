"""Device-resident dataset store: validation batches with no host traffic.

Port of ``dahpe_tpu/data/device_store.py`` (the upload and the eval loader;
the training sampler comes with the training path). The pre-decoded uint8
crops of a split, with their keypoints, visibility and intrinsics, are
uploaded to the card once; every eval batch is then a row gather, the
ImageNet normalize and the Gaussian targets, all on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device
from dahpe_tpu_torch.core.heatmap import generate_target
from dahpe_tpu_torch.data.device_aug import IMAGENET_MEAN, IMAGENET_STD


class DeviceDataStore:
    """Pre-decoded crops resident on one device.

    Args:
      source: anything with ``len``, ``num_keypoints`` and
        ``fetch_raw(i, rng, raw_size)`` returning ``image_u8 (s, s, 3)``,
        ``keypoint2d (K, 2)``, ``visible (K,)`` and ``intrinsic_matrix
        (3, 3)`` — the JAX package's protocol.
      device: where the store lives (default: the card).
      raw_size: side of the stored crops.
      upload_chunk: rows per host→device copy during the one-time upload.
    """

    def __init__(self, source, *, device=None, raw_size: int = 288,
                 upload_chunk: int = 512, verbose: bool = True):
        self.device = resolve_device(device)
        self.raw_size = s = int(raw_size)
        self.n = n = len(source)
        if n == 0:
            raise ValueError("DeviceDataStore: empty source")
        k = source.num_keypoints
        rng = np.random.default_rng(0)  # fetch_raw does not consume it

        self.images = torch.empty((n, s, s, 3), dtype=torch.uint8, device=self.device)
        self.kps = torch.empty((n, k, 2), dtype=torch.float32, device=self.device)
        self.vis = torch.empty((n, k), dtype=torch.float32, device=self.device)
        self.intr = torch.empty((n, 3, 3), dtype=torch.float32, device=self.device)
        for start in range(0, n, upload_chunk):
            stop = min(start + upload_chunk, n)
            imgs = np.empty((stop - start, s, s, 3), np.uint8)
            kp = np.empty((stop - start, k, 2), np.float32)
            vi = np.empty((stop - start, k), np.float32)
            it = np.empty((stop - start, 3, 3), np.float32)
            for j, i in enumerate(range(start, stop)):
                item = source.fetch_raw(i, rng, s)
                imgs[j] = item["image_u8"]
                kp[j] = item["keypoint2d"]
                vi[j] = np.reshape(item["visible"], (k,))
                it[j] = item["intrinsic_matrix"]
            for dst, src in ((self.images, imgs), (self.kps, kp),
                             (self.vis, vi), (self.intr, it)):
                dst[start:stop].copy_(torch.from_numpy(src))
            if verbose and start // upload_chunk % 8 == 0:
                print(f"device-store upload: {stop}/{n}", flush=True)

    def nbytes(self) -> int:
        return sum(
            x.numel() * x.element_size()
            for x in (self.images, self.kps, self.vis, self.intr)
        )

    def eval_loader(self, batch_size: int, *, heatmap_size: int = 64,
                    sigma: float = 2.0) -> "_DeviceEvalLoader":
        """Device-resident validation loader for ``evaluate.validate``.

        Build the store at ``raw_size == image_size``: the device then only
        normalizes and renders the Gaussian targets. Trailing batches are
        padded with clipped duplicate rows whose targets and weights are
        zero-masked, so they contribute nothing to PCK.
        """
        return _DeviceEvalLoader(self, batch_size, heatmap_size, sigma)


class _DeviceEvalLoader:
    """Sequential, fixed-shape validation batches straight from the card."""

    device_finalized = True

    def __init__(self, store: DeviceDataStore, batch_size: int,
                 heatmap_size: int, sigma: float):
        self.store = store
        self.batch_size = int(batch_size)
        self.heatmap_size = int(heatmap_size)
        self.sigma = float(sigma)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=store.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=store.device)

    def __len__(self) -> int:
        return -(-self.store.n // self.batch_size)

    def batch(self, start: int) -> dict[str, torch.Tensor]:
        """The fixed-shape batch of rows ``start .. start + batch_size``."""
        s, hm = self.store, self.heatmap_size
        rows = start + torch.arange(self.batch_size, device=s.device)
        valid = (rows < s.n).to(torch.float32)
        idx = rows.clamp(0, s.n - 1)
        img = s.images.index_select(0, idx).to(torch.float32) / 255.0
        img = (img - self._mean) / self._std
        target, weight = generate_target(
            s.kps.index_select(0, idx), s.vis.index_select(0, idx),
            (hm, hm), (s.raw_size, s.raw_size), sigma=self.sigma,
        )
        # zero-mask the clipped duplicate padding rows: all-zero targets fail
        # pck_accuracy's peak validity filter
        target = target * valid[:, None, None, None]
        weight = weight * valid[:, None]
        return {"image": img, "target": target, "weight": weight}

    def __iter__(self):
        n, b = self.store.n, self.batch_size
        for start in range(0, n, b):
            yield {"batch": self.batch(start), "n_real": min(b, n - start)}
