"""Shared CLI plumbing: flag checks, model and dataset construction, loaders.

Port of ``dahpe_tpu/cli/common.py``. One process drives one device
(``--device``); the JAX package's compile cache has no counterpart.
"""

from __future__ import annotations

import hashlib
import os

import torch

from dahpe_tpu_torch import models
from dahpe_tpu_torch.data import BatchLoader, DecodedCache, get_dataset
from dahpe_tpu_torch.data import transforms as T

# flag -> why it is refused: paths of the JAX package not ported yet
_UNPORTED = {
    "host_warp": "--host-warp (the native fused host warp) is not ported yet "
                 "(ROADMAP.md queue 1 item 8)",
    "multihost": "--multihost (multi-process data parallelism) is not ported yet "
                 "(ROADMAP.md queue 1 item 11)",
    "bf16": "--bf16 (bfloat16 compute) is not ported yet (ROADMAP.md queue 1 item 9)",
    "debug": "--debug (cv2 skeleton visualisations) is not ported yet "
             "(ROADMAP.md queue 1 item 9)",
    "artifact": "--artifact (exported serving artifacts) is not ported yet "
                "(ROADMAP.md queue 1 item 12)",
}


def refuse_unported(args) -> None:
    """Raise ``SystemExit`` naming the ROADMAP item of any flag whose path is
    not ported; none of them is silently ignored."""
    for flag, why in _UNPORTED.items():
        if getattr(args, flag, None):
            raise SystemExit(why)


def validate_steps_per_call(args) -> int:
    """``--steps-per-call`` as a chunk size: only K = 1 is ported.

    K < 1 is rejected (the JAX package coerces 0 and negative values to 1),
    and K > 1 (a CUDA-graph replay of K iterations) is ROADMAP queue 1
    item 7. Checked before anything runs, on every input mode."""
    k = int(args.steps_per_call)
    if k < 1:
        raise SystemExit(f"--steps-per-call {k}: K must be at least 1")
    if k > 1:
        raise SystemExit(f"--steps-per-call {k}: K > 1 (a CUDA-graph replay of K "
                         "iterations) is not ported yet (ROADMAP.md queue 1 item 7)")
    return k


def build_model(args, multi_head: bool = True) -> torch.nn.Module:
    """The ``-a`` backbone under the multi-head DA model (or the pretrain
    ``PoseResNet``), its initial weights drawn from ``torch.manual_seed(
    args.seed)``, on the CPU (the train states move it to ``--device``)."""
    torch.manual_seed(args.seed)
    backbone = models.get_backbone(args.arch)
    if multi_head:
        return models.MultiHeadPoseResNet(backbone, num_keypoints=21,
                                          num_head_layers=args.num_head_layers)
    return models.PoseResNet(backbone, num_keypoints=21)


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
    transforms) or ``raw`` (decode-only, augmentation on the device)."""
    if getattr(args, "host_warp", False):
        raise SystemExit(_UNPORTED["host_warp"])
    return "raw" if getattr(args, "device_aug", False) else "pil"


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
    """One shuffled train loader in the requested pipeline mode."""
    if mode not in ("pil", "raw"):
        raise ValueError(f"unknown train loader mode {mode!r}")
    if mode == "raw":
        # the PIL mode is the reference-parity path, uncached on purpose
        dataset = maybe_decoded_cache(args, dataset)
    return BatchLoader(dataset, args.batch_size, shuffle=True, drop_last=True,
                       num_workers=args.workers, seed=args.seed + seed_offset,
                       raw=mode == "raw")


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
