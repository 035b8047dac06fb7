"""Input pipeline: threaded host loading, infinite iteration, batch
finalization on the device.

Port of ``dahpe_tpu/data/pipeline.py`` (reference: ``DataLoader(num_workers=4,
pin_memory=True)`` + ``ForeverDataIterator``, ``train1.py:76-77``,
``utils/data.py:4-19``):

  host threads: file read + decode + crop + PIL transforms → numpy batch
                (or, warped, one fused native warp + photometrics a sample)
  device:       Gaussian targets (``generate_target``, the CUDA kernel on the
                card), or for raw batches the whole augmentation
                (:func:`device_train_batch`, the rotation kernel on the
                loader's uint8)

:class:`BatchLoader` makes the same seeded epoch permutation and host shards
as the JAX package's, so both packages visit samples in the same order.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device
from dahpe_tpu_torch.core.heatmap import generate_target


def finalize_batch(
    batch: dict,
    *,
    heatmap_size=(64, 64),
    image_size=(256, 256),
    sigma: float = 2.0,
    device=None,
) -> dict:
    """The train/eval-step batch from a host batch: ``image`` moved to
    ``device`` (default the card), targets and weights rendered there.
    ``batch`` values may be numpy arrays or tensors (already on ``device``
    after :func:`device_prefetch`)."""
    device = resolve_device(device)

    def put(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    target, weight = generate_target(
        put(batch["keypoint2d"]).to(torch.float32),
        put(batch["visible"]).to(torch.float32),
        tuple(heatmap_size),
        tuple(image_size),
        sigma=sigma,
    )
    return {"image": put(batch["image"]).to(torch.float32), "target": target,
            "weight": weight}


class ForeverIterator:
    """Infinite epoch-free iterator (``utils/data.py:4-19`` semantics)."""

    def __init__(self, make_iter):
        self._make_iter = make_iter
        self._it = make_iter()

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = self._make_iter()
            return next(self._it)

    def __iter__(self):
        return self


class BatchLoader:
    """Threaded batch loader over a KeypointDataset.

    Each worker thread owns a ``numpy.random.Generator`` seeded from the
    seed, the epoch and its worker id, so augmentation is reproducible per
    worker; the batch order is the seeded epoch permutation (``seed +
    epoch``), of which host ``host_index`` of ``host_count`` takes a
    disjoint stride. ``raw`` fetches decoded uint8 crops of ``raw_size``
    (``--device-aug``), ``warped`` the native library's augmented
    ``image_size`` frames (``--host-warp``), else the PIL transforms.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 4,
        raw: bool = False,
        raw_size: int = 288,
        warped: bool = False,
        image_size: int = 256,
        host_index: int = 0,
        host_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.raw = raw
        self.raw_size = raw_size
        self.warped = warped
        self.image_size = image_size
        self.host_index = host_index
        self.host_count = host_count
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        if self.host_count > 1:
            order = order[self.host_index :: self.host_count]
            n = len(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i : i + self.batch_size]

    def _collate(self, items: list[dict]) -> dict:
        keys = [k for k, v in items[0].items() if isinstance(v, np.ndarray)]
        return {k: np.stack([it[k] for it in items]) for k in keys}

    def __iter__(self):
        self._epoch += 1
        batches = list(self._index_batches())
        idx_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            idx_q.put((bi, b))

        # in-order hand-off: workers park finished batches in `ready` and
        # sleep once they are more than a prefetch window ahead of the consumer
        ready: dict[int, dict] = {}
        cond = threading.Condition()
        cursor = {"next": 0}
        window = self.prefetch + self.num_workers
        epoch = self._epoch

        def worker(wid: int):
            rng = np.random.default_rng(self.seed * 100003 + epoch * 1009 + wid)
            while True:
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                if self.warped:
                    items = [self.dataset.fetch_warped(int(i), rng, image_size=self.image_size)
                             for i in idxs]
                elif self.raw:
                    items = [self.dataset.fetch_raw(int(i), rng, self.raw_size) for i in idxs]
                else:
                    items = [self.dataset.fetch(int(i), rng) for i in idxs]
                batch = self._collate(items)
                with cond:
                    # the worker holding the consumer's next batch never
                    # waits, so the hand-off cannot deadlock
                    while bi - cursor["next"] >= window:
                        cond.wait()
                    ready[bi] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        for bi in range(len(batches)):
            with cond:
                while bi not in ready:
                    cond.wait()
                batch = ready.pop(bi)
                cursor["next"] = bi + 1
                cond.notify_all()
            yield batch


def device_train_batch(
    batch: dict,
    generator: torch.Generator,
    *,
    image_size: int = 256,
    heatmap_size: int = 64,
    rotation: float = 180.0,
    scale_range: tuple[float, float] = (0.6, 1.3),
    sigma: float = 2.0,
) -> dict:
    """Finalization of a raw uint8 batch (``BatchLoader(raw=True)``) on the
    generator's device: the augmentation draws come from ``generator``, the
    crops stay uint8 until the rotation kernel reads them, then the Gaussian
    targets (the ``--device-aug`` path)."""
    from dahpe_tpu_torch.data.device_aug import augment_batch, draw_augment_params

    device = generator.device
    images = torch.as_tensor(batch["image_u8"]).to(device, non_blocking=True)
    b, size = images.shape[0], images.shape[1]
    params = draw_augment_params(generator, b, size=size, rotation=rotation,
                                 scale_range=tuple(scale_range))
    img, kp, _ = augment_batch(
        images,
        torch.as_tensor(batch["keypoint2d"]).to(device, torch.float32),
        torch.as_tensor(batch["intrinsic_matrix"]).to(device, torch.float32),
        params, out_size=image_size,
    )
    target, weight = generate_target(
        kp, torch.as_tensor(batch["visible"]).to(device, torch.float32),
        (heatmap_size, heatmap_size), (image_size, image_size), sigma=sigma,
    )
    return {"image": img, "target": target, "weight": weight}


def device_prefetch(iterator, finalize, size: int = 2, *, device=None):
    """Overlap host loading and the host→device copy with device compute.

    Host batches (dicts of numpy arrays) are copied ``size`` ahead into
    pinned memory and to ``device`` on a side stream; each is handed to
    ``finalize`` on the current stream once its copy has landed (the
    current stream waits on the copy's event, the host does not). On the CPU
    the batches go to ``finalize`` as they are.
    """
    device = resolve_device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None

    def start(host):
        if not on_card:
            return host, None
        with torch.cuda.stream(side):
            moved = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                     .to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return moved, done

    buf = collections.deque()
    it = iter(iterator)
    while True:
        while len(buf) < size:
            try:
                buf.append(start(next(it)))
            except StopIteration:
                break
        if not buf:
            return
        moved, done = buf.popleft()
        if done is not None:
            torch.cuda.current_stream(device).wait_event(done)
            for v in moved.values():
                v.record_stream(torch.cuda.current_stream(device))
        yield finalize(moved)
