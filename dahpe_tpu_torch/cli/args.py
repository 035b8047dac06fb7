"""Shared argparse flags, mirroring the reference CLI (``train1.py:602-674``).

Port of ``dahpe_tpu/cli/args.py``: the same flags and defaults, plus
``--device`` (default ``cuda``; the CPU runs only when asked for). Flags
whose paths are not ported yet are accepted by the parser and refused by
the CLIs with the ROADMAP item that ports them
(:func:`dahpe_tpu_torch.cli.common.refuse_unported`).
"""

from __future__ import annotations

import argparse

from dahpe_tpu_torch import models
from dahpe_tpu_torch.data import DATASETS


def build_parser(phase: str = "train") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Domain-adaptive hand keypoint detection (PyTorch/CUDA)"
    )
    parser.add_argument("target_root", help="root path of the target dataset")
    parser.add_argument("--source_root", default="data/RHD", help="root of source dataset")
    parser.add_argument("-s", "--source", default="RenderedHandPose",
                        choices=sorted(DATASETS))
    parser.add_argument("-t", "--target", choices=sorted(DATASETS), required=True)
    parser.add_argument("--resize-scale", nargs="+", type=float, default=(0.6, 1.3))
    parser.add_argument("--rotation", type=int, default=180)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--heatmap-size", type=int, default=64)
    parser.add_argument("-a", "--arch", default="resnet101",
                        choices=sorted(models.BACKBONES))
    parser.add_argument("--pretrain", type=str, default=None,
                        help="pretrained checkpoint (checkpoint dir of this "
                             "package or of dahpe_tpu, or a reference .pth)")
    parser.add_argument("--imagenet-pth", type=str, default=None,
                        help="torchvision ImageNet .pth for backbone init "
                             "(nothing is downloaded)")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--num-head-layers", type=int, default=2)
    parser.add_argument("--trade-off", default=1.0, type=float)
    parser.add_argument("-b", "--batch-size", default=32, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--wd", "--weight-decay", default=1e-4, type=float, dest="wd")
    parser.add_argument("--lr-gamma", default=1e-4, type=float)
    parser.add_argument("--lr-decay", default=0.75, type=float)
    parser.add_argument("--lr-step", default=[45, 60], nargs="+", type=int)
    parser.add_argument("--lr-factor", default=0.1, type=float)
    parser.add_argument("-j", "--workers", default=4, type=int)
    parser.add_argument("--pretrain-epochs", default=70, type=int)
    parser.add_argument("--epochs", default=200, type=int)
    parser.add_argument("-i", "--iters-per-epoch", default=500, type=int)
    parser.add_argument("-p", "--print-freq", default=100, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--log", type=str, default="logs/mt")
    parser.add_argument("--phase", type=str, default=phase, choices=["train", "test"])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (default: the card); "
                             "'cpu' runs on the CPU")
    parser.add_argument("--debug", action="store_true",
                        help="draw predicted skeletons of the printed train "
                             "batches and the target validation into "
                             "{log}/visualize (cv2)")
    parser.add_argument("--profile", default=0, type=int, metavar="N",
                        help="capture a torch.profiler trace of N "
                             "steady-state DA iterations (written under "
                             "{log}/trace with a busy/idle summary)")
    parser.add_argument("--keep-checkpoints", default=0, type=int,
                        metavar="N",
                        help="retain only the newest N per-epoch checkpoint "
                             "dirs (best/model_ema/pretrain are never "
                             "pruned); 0 keeps all — long production runs "
                             "save a full optimizer+EMA state every epoch")
    parser.add_argument("--save-every", default=0, type=int, metavar="N",
                        help="write a mid-epoch 'latest' checkpoint (full "
                             "state + sampling-stream sidecar) every N DA "
                             "iterations; 0 = per-epoch only. --resume from "
                             "'latest' continues mid-epoch, bit-identically "
                             "on the device-store path")
    parser.add_argument("--max-steps", default=0, type=int, metavar="N",
                        help="stop after N total DA optimizer steps (across "
                             "resumes), saving the 'latest' checkpoint and "
                             "exiting cleanly; 0 = no limit")
    parser.add_argument("--ema-decay", default=0.99, type=float,
                        help="EMA-twin decay (the reference fixes 0.999 "
                             "untuned; the JAX package's r5 sweep measured "
                             "0.99, docs/ACCURACY.md)")
    parser.add_argument("--conf-gate", default=0.0, type=float, metavar="Q",
                        help="drop the per-joint fraction Q of least-"
                             "confident target pseudo-labels in the "
                             "adversarial steps (batch-relative peak-"
                             "activation quantile). 0 = off, the reference "
                             "behavior")
    parser.add_argument("--with-ema", action="store_true",
                        help="maintain + update the EMA twin each iteration "
                             "(the reference creates it but leaves the update "
                             "commented out, train1.py:461)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute dtype (parameters, BN statistics "
                             "and labels stay float32)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-process data parallelism; not ported yet")
    parser.add_argument("--device-store", action="store_true",
                        help="upload the pre-decoded dataset to the device "
                             "once (data/device_store.py) and run the ENTIRE "
                             "train input path there: per-iteration sample "
                             "gather + augmentation + Gaussian targets, no "
                             "host traffic. Combine with --decoded-cache to "
                             "make the one-time upload decode-free")
    parser.add_argument("--steps-per-call", default=1, type=int, metavar="K",
                        help="train iterations per fused call (needs "
                             "--device-store for K > 1): on the card one "
                             "captured iteration replayed K times as a CUDA "
                             "graph; printed metrics are chunk means, and "
                             "--iters-per-epoch, --print-freq, --save-every "
                             "and --max-steps must be multiples of K")
    parser.add_argument("--device-aug", action="store_true",
                        help="host threads only decode+crop; all augmentation "
                             "(rotation kernel, crop-resize, jitter, blur, "
                             "normalize) runs batched on the device")
    parser.add_argument("--decoded-cache", type=str, default=None,
                        help="directory for the pre-decoded crop cache "
                             "(data/cache.py): the decode+crop+resize prefix "
                             "is materialized once, after which fetches are "
                             "mmap reads (--device-aug, --device-store)")
    parser.add_argument("--host-warp", action="store_true",
                        help="native fused host augmentation; not ported yet")
    if phase == "test":
        parser.add_argument("--checkpoint", type=str, default=None,
                            help="checkpoint to evaluate (checkpoint dir of "
                                 "this package or of dahpe_tpu, or a .pth)")
        parser.add_argument("--artifact", type=str, default=None,
                            help="evaluate an exported serving artifact "
                                 "(cli.export, float or int8, float32 input) "
                                 "instead of a checkpoint")
    return parser
