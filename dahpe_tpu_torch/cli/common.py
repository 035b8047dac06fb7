"""Shared CLI plumbing: flag checks, model and dataset construction, loaders,
the ``--debug`` visualiser.

Port of ``dahpe_tpu/cli/common.py``. One process drives one device
(``--device``; under ``--multihost`` each rank its own, and its share of
the global batch); the JAX package's compile cache has no counterpart.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from dahpe_tpu_torch import models, parallel
from dahpe_tpu_torch.data import BatchLoader, DecodedCache, get_dataset
from dahpe_tpu_torch.data import transforms as T
from dahpe_tpu_torch.utils import native


def validate_steps_per_call(args) -> int:
    """``--steps-per-call`` as a chunk size K, checked before anything runs.

    K > 1 runs K iterations per fused call (a CUDA graph replayed K times on
    the card, ``train/fused.py``), so every host-side boundary (progress
    reports, the stop poll, ``--save-every`` checkpoints, ``--max-steps``)
    can only land on a multiple of K: it needs ``--device-store`` (the
    host-fed paths need a host round trip per step) and cadences that are
    multiples of K, as in the JAX package; ``--debug`` draws the batches of
    every printed step on the host, so it runs one step a call. A K below 1
    is rejected (the JAX package coerces it to 1). Under ``--multihost`` on
    gloo with more than one rank (``DAHPE_DIST_BACKEND=gloo``), a card
    cannot capture the collectives, so K > 1 is refused there."""
    k = int(args.steps_per_call)
    if k < 1:
        raise SystemExit(f"--steps-per-call {k}: K must be at least 1")
    if k == 1:
        return k
    if (getattr(args, "multihost", False) and torch.device(args.device).type == "cuda"
            and parallel.distributed.backend_for(args.device) == "gloo"
            and parallel.distributed.planned_world_size() > 1):
        raise SystemExit(
            f"--steps-per-call {k} under gloo: gloo's collectives cannot be captured in a "
            "CUDA graph; run K = 1 on gloo, or NCCL with one card per rank")
    if not args.device_store:
        raise SystemExit(
            f"--steps-per-call {k} needs --device-store: only the fused iteration "
            "runs steps without a host round trip per step")
    if getattr(args, "debug", False):
        raise SystemExit(
            f"--steps-per-call {k} runs without --debug: the debug drawings need "
            "each printed step's batches on the host")
    bad = [f"{name}={value}" for name, value in (
        ("--iters-per-epoch", args.iters_per_epoch),
        ("--print-freq", args.print_freq),
        ("--save-every", args.save_every),
        ("--max-steps", args.max_steps),
    ) if value and value % k]
    if bad:
        raise SystemExit(
            f"--steps-per-call {k}: {', '.join(bad)} must be multiples of K: chunk "
            "boundaries are the only report, checkpoint and stop points of a chunked run")
    return k


def check_world(args, world: int) -> None:
    """The global batch ``-b`` must split into equal rank batches: the
    gradient is the mean of the ranks' local means, which is the global
    mean only when every rank holds as many rows."""
    if args.batch_size % world:
        raise SystemExit(
            f"-b {args.batch_size} does not split over {world} ranks: each rank holds "
            "batch/W rows, and the mean of the ranks' means is the global mean only "
            "for equal shares; make the batch a multiple of the world size")


def build_model(args, multi_head: bool = True) -> torch.nn.Module:
    """The ``-a`` backbone under the multi-head DA model (or the pretrain
    ``PoseResNet``), computing in bfloat16 with ``--bf16`` (float32
    parameters), its initial weights drawn from ``torch.manual_seed(
    args.seed)``, on the CPU (the train states move it to ``--device``)."""
    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if args.bf16 else None
    backbone = models.get_backbone(args.arch, dtype=dtype)
    if multi_head:
        return models.MultiHeadPoseResNet(backbone, num_keypoints=21,
                                          num_head_layers=args.num_head_layers, dtype=dtype)
    return models.PoseResNet(backbone, num_keypoints=21, dtype=dtype)


def build_datasets(args, *, val_only: bool = False):
    """The four dataset splits; ``val_only=True`` skips the two train splits
    (the eval CLI never touches them)."""
    val_tf = T.val_transform(args.image_size)
    common = dict(
        image_size=(args.image_size, args.image_size),
        heatmap_size=(args.heatmap_size, args.heatmap_size),
    )
    if val_only:
        train_source = train_target = None
    else:
        train_tf = T.train_transform(args.image_size, args.rotation, tuple(args.resize_scale))
        train_source = get_dataset(args.source, root=args.source_root,
                                   transforms=train_tf, **common)
        train_target = get_dataset(args.target, root=args.target_root,
                                   transforms=train_tf, **common)
    val_source = get_dataset(args.source, root=args.source_root, split="test",
                             transforms=val_tf, **common)
    val_target = get_dataset(args.target, root=args.target_root, split="test",
                             transforms=val_tf, **common)
    return train_source, val_source, train_target, val_target


def train_loader_mode(args) -> str:
    """Which host pipeline the train loaders use: ``pil`` (reference-parity
    transforms), ``raw`` (decode-only, augmentation on the device) or
    ``warped`` (the native fused host augmentation, ``--host-warp``);
    ``--device-aug`` wins over ``--host-warp``, as in the JAX package."""
    if getattr(args, "device_aug", False):
        return "raw"
    if getattr(args, "host_warp", False):
        return "warped"
    return "pil"


def maybe_decoded_cache(args, dataset, *, raw_size: int = 288):
    """``dataset`` behind the pre-decoded mmap cache when ``--decoded-cache``
    is set (``data/cache.py``); the directory name is the JAX package's, so
    both packages share a cache."""
    if not getattr(args, "decoded_cache", None):
        return dataset
    root_tag = hashlib.sha1(os.path.abspath(getattr(dataset, "root", "")).encode()).hexdigest()[:8]
    tag = f"{type(dataset).__name__}_{getattr(dataset, 'split', 'x')}_{raw_size}_{root_tag}"
    return DecodedCache(dataset, os.path.join(args.decoded_cache, tag), raw_size=raw_size,
                        num_workers=args.workers)


def build_train_loader(args, dataset, *, seed_offset: int = 0, mode: str = "pil"):
    """One shuffled train loader in the requested pipeline mode. Under
    ``--multihost`` each rank loads a disjoint shard of every epoch and its
    ``batch / W`` rows of the global batch."""
    if mode not in ("pil", "raw", "warped"):
        raise ValueError(f"unknown train loader mode {mode!r}")
    if mode == "warped":
        native.load()  # a library that does not build fails the run here
    if mode != "pil":
        # the PIL mode is the reference-parity path, uncached on purpose
        dataset = maybe_decoded_cache(args, dataset)
    world = parallel.world_size()
    return BatchLoader(dataset, args.batch_size // world, shuffle=True, drop_last=True,
                       num_workers=args.workers, seed=args.seed + seed_offset,
                       raw=mode == "raw", warped=mode == "warped", image_size=args.image_size,
                       host_index=parallel.rank(), host_count=world)


def build_val_loader(args, dataset):
    """Full-batch sequential eval loader."""
    return BatchLoader(dataset, args.batch_size, shuffle=False, drop_last=False,
                       num_workers=args.workers, seed=args.seed)


def build_device_val_loader(args, dataset, *, name=""):
    """Device-resident validation loader (``--device-store``): the val split
    is uploaded once at ``raw_size == image_size`` (the deterministic PIL val
    geometry baked in) and every eval batch is an on-device gather,
    normalize and Gaussian targets."""
    from dahpe_tpu_torch.data.device_store import DeviceDataStore

    store = DeviceDataStore(maybe_decoded_cache(args, dataset, raw_size=args.image_size),
                            device=args.device, raw_size=args.image_size, verbose=False)
    print(f"device store (val {name}): {store.n} samples, {store.nbytes() / 1e9:.2f} GB")
    return store.eval_loader(args.batch_size, heatmap_size=args.heatmap_size)


def build_loaders(args, train_source, val_source, train_target, val_target, *,
                  train_mode=None):
    mode = train_loader_mode(args) if train_mode is None else train_mode
    return (
        build_train_loader(args, train_source, seed_offset=0, mode=mode),
        build_val_loader(args, val_source),
        build_train_loader(args, train_target, seed_offset=1, mode=mode),
        build_val_loader(args, val_target),
    )


def make_visualizer(dataset, logger):
    """``visualize(image, keypoints, name)`` for ``--debug``: the normalized
    ``(H, W, 3)`` image back to uint8 RGB, the skeleton of ``keypoints``
    (image pixels) drawn by ``dataset.visualize`` into the run's
    ``visualize/`` directory as ``{name}.jpg``."""

    def visualize(image, keypoint2d, name):
        img = (T.denormalize(np.asarray(image)) * 255).astype(np.uint8)
        dataset.visualize(img, keypoint2d, logger.get_image_path(f"{name}.jpg"))

    return visualize
