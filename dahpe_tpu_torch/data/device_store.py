"""Device-resident dataset store: training and validation batches with no
host traffic.

Port of ``dahpe_tpu/data/device_store.py`` for one device (per-rank sample
shards come with the parallel slice). The pre-decoded uint8 crops of a
split, with their keypoints, visibility and intrinsics, are uploaded to the
card once. Every training batch is then

    sample indices (a generator on the device) → flat-view row gather
    → augmentation (``device_aug``) → Gaussian targets

and every eval batch a row gather, the ImageNet normalize and the targets,
all on the device. Sampling is without replacement within a batch and with
replacement across batches, the DA trainer's infinite-iterator regime.
"""

from __future__ import annotations

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device
from dahpe_tpu_torch.core.heatmap import generate_target
from dahpe_tpu_torch.data.device_aug import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    augment_batch,
    draw_augment_params,
)


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
        self._stream: torch.Generator | None = None  # seed_stream

    def nbytes(self) -> int:
        return sum(
            x.numel() * x.element_size()
            for x in (self.images, self.kps, self.vis, self.intr)
        )

    def generator(self, seed: int) -> torch.Generator:
        """A fresh random generator on the store's device."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def train_batch_from(self, idx: torch.Tensor, params: dict, *, image_size: int = 256,
                         heatmap_size: int = 64, sigma: float = 2.0) -> dict:
        """The training batch of rows ``idx`` under the augmentation draws
        ``params`` (``device_aug.draw_augment_params``): gather, augment,
        Gaussian targets. The image rows are gathered through a flat
        ``(n, h*w*c)`` view, one contiguous row copy each."""
        h, w, c = self.images.shape[1:]
        img = self.images.view(self.n, h * w * c).index_select(0, idx).view(-1, h, w, c)
        img, kp, _ = augment_batch(
            img, self.kps.index_select(0, idx), self.intr.index_select(0, idx), params,
            out_size=image_size,
        )
        target, weight = generate_target(
            kp, self.vis.index_select(0, idx), (heatmap_size, heatmap_size),
            (image_size, image_size), sigma=sigma,
        )
        return {"image": img, "target": target, "weight": weight}

    def traced_batch_fn(self, batch_size: int, *, image_size: int = 256,
                        heatmap_size: int = 64, rotation: float = 180.0,
                        scale_range=(0.6, 1.3), sigma: float = 2.0):
        """The batch producer ``generator -> batch``: ``batch_size`` rows
        drawn without replacement (``torch.randperm`` on the generator),
        their augmentation draws from the same generator, then
        :meth:`train_batch_from`. Nothing is read back to the host."""
        if not 0 < batch_size <= self.n:
            raise ValueError(f"batch {batch_size} not in 1..{self.n} (store rows)")
        cfg = dict(image_size=image_size, heatmap_size=heatmap_size, sigma=sigma)

        def produce(generator: torch.Generator) -> dict:
            idx = torch.randperm(self.n, generator=generator, device=self.device)[:batch_size]
            params = draw_augment_params(generator, batch_size, size=self.raw_size,
                                         rotation=rotation, scale_range=scale_range)
            return self.train_batch_from(idx, params, **cfg)

        return produce

    def train_batch(self, generator_or_seed, batch_size: int, **cfg) -> dict:
        """One training batch from a generator on the store's device, or from
        a fresh one seeded with an int (``cfg``: :meth:`traced_batch_fn`'s)."""
        g = generator_or_seed
        if not isinstance(g, torch.Generator):
            g = self.generator(g)
        return self.traced_batch_fn(batch_size, **cfg)(g)

    def seed_stream(self, seed_or_state) -> None:
        """Start the store's sampling stream: an int seed, or a state that
        :meth:`stream_data` returned (resume continues the same stream)."""
        g = torch.Generator(device=self.device)
        if isinstance(seed_or_state, torch.Tensor):
            g.set_state(seed_or_state)
        else:
            g.manual_seed(int(seed_or_state))
        self._stream = g

    def stream_data(self) -> torch.Tensor | None:
        """The sampling stream's generator state (a CPU byte tensor, for
        checkpointing), or ``None`` before :meth:`seed_stream`."""
        return None if self._stream is None else self._stream.get_state()

    def next_train_batch(self, batch_size: int, **cfg) -> dict:
        """The next training batch of the stream; the generator advances on
        the device."""
        if self._stream is None:
            raise ValueError("call seed_stream(seed) before next_train_batch")
        return self.traced_batch_fn(batch_size, **cfg)(self._stream)

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
