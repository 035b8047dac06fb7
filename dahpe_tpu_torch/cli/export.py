"""Serving-export CLI: checkpoint → ``torch.export`` artifact.

Port of ``dahpe_tpu/cli/export.py``.
``python -m dahpe_tpu_torch.cli.export <checkpoint> -o model.pt2`` loads a
checkpoint (a packed directory of this package or of the JAX package, or a
reference torch ``.pth``) and exports the fused forward-plus-decode serving
program (images → image-space keypoints + confidences) with
:mod:`dahpe_tpu_torch.serving`, beside its weights as ``<output>.weights.npz``.
``--int8`` exports the post-training-quantized program
(:mod:`dahpe_tpu_torch.quant`) instead. ``--bf16`` exports a float program
that computes in bfloat16 (its weights stay float32; ``--int8`` quantizes
the float32 weights whatever the flag, as the JAX package does). The
artifact runs on the device it was exported on (``--device``, default
``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dahpe_tpu_torch import models, resolve_device, serving
from dahpe_tpu_torch.utils import checkpoint as ckpt


def build_export_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export the serving program (torch.export)"
    )
    p.add_argument("checkpoint",
                   help="checkpoint dir (packed, of this package or of dahpe_tpu) "
                        "or reference .pth")
    p.add_argument("-o", "--output", required=True, help="output artifact path")
    p.add_argument("-a", "--arch", default="resnet101", choices=sorted(models.BACKBONES))
    p.add_argument("--num-head-layers", type=int, default=2)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--heatmap-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=None,
                   help="fixed batch; omit for a batch-polymorphic artifact")
    p.add_argument("--device", default="cuda",
                   help="torch device the artifact runs on (default: the card)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype (weights stay float32; the casts "
                        "are part of the exported program); --int8 ignores it")
    p.add_argument("--uint8-input", action="store_true",
                   help="artifact ingests raw uint8 HWC frames and normalizes on "
                        "the device (4x fewer bytes per frame than a float32 feed)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization (dahpe_tpu_torch.quant): "
                        "BN-folded per-channel int8 convs through torch._int_mm")
    p.add_argument("--int8-glue", choices=["bfloat16", "float32"], default="bfloat16",
                   help="inter-conv activation storage dtype of the int8 artifact")
    p.add_argument("--calib-npz", default=None,
                   help="calibration images for --int8: an .npz with 'images' "
                        "(normalized model inputs, NHWC float) or 'frames' (raw "
                        "uint8 HWC, normalized here); without it calibration falls "
                        "back to random frames — fine for scale coverage, but pass "
                        "real data for deployment")
    p.add_argument("--calib-percentile", type=float, default=None,
                   help="robust --int8 calibration: use this percentile of "
                        "|activation| (e.g. 99.9) instead of the absolute max, so "
                        "one outlier calibration batch can't crush the int8 "
                        "resolution (quant.calibrate_act_scales)")
    return p


def _calibration_images(args, device) -> torch.Tensor:
    """Normalized NHWC calibration batch for --int8 on ``device``:
    user-supplied images (``--calib-npz``) or, as a fallback, random frames
    through the ImageNet normalization (covers the activation-scale range;
    real data is better — say so on stderr)."""
    from dahpe_tpu_torch.data.device_aug import IMAGENET_MEAN, IMAGENET_STD

    def normalize(frames):
        x = torch.as_tensor(np.asarray(frames), dtype=torch.float32, device=device) / 255.0
        return (x - torch.as_tensor(IMAGENET_MEAN, device=device)) / torch.as_tensor(
            IMAGENET_STD, device=device)

    if args.calib_npz:
        with np.load(args.calib_npz) as data:
            if "images" in data:
                return torch.as_tensor(data["images"], dtype=torch.float32, device=device)
            if "frames" in data:
                return normalize(data["frames"])
        raise SystemExit(f"--calib-npz {args.calib_npz}: need 'images' or 'frames'")
    print("--int8 without --calib-npz: calibrating on random frames "
          "(pass real data for deployment accuracy)", file=sys.stderr)
    rng = np.random.default_rng(0)
    return normalize(rng.integers(0, 256, (8, args.image_size, args.image_size, 3)))


def main(args) -> str:
    """Export ``args.checkpoint``; returns the artifact path."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else None
    model = models.MultiHeadPoseResNet(models.get_backbone(args.arch, dtype=dtype),
                                       num_keypoints=21,
                                       num_head_layers=args.num_head_layers, dtype=dtype)
    if args.checkpoint.endswith(".pth"):
        ckpt.load_reference_pth(args.checkpoint, model, strict=True)
    else:
        model.load_state_dict(ckpt.load_model_variables(args.checkpoint))
    model.eval().to(device)
    weights = args.output + ".weights.npz"
    geometry = dict(batch_size=args.batch_size, image_size=args.image_size,
                    heatmap_size=args.heatmap_size, uint8_input=args.uint8_input,
                    device=device)
    if args.int8:
        from dahpe_tpu_torch import quant

        qtree = quant.quantize_model(model, _calibration_images(args, device),
                                     percentile=args.calib_percentile)
        blob = serving.export_predict_int8(qtree, glue=args.int8_glue, **geometry)
        with open(args.output, "wb") as f:
            f.write(blob)
        serving.save_quantized_npz(weights, qtree)
    else:
        serving.save_predict(args.output, model, **geometry)
        serving.save_variables_npz(weights, model)
    b = args.batch_size if args.batch_size is not None else "polymorphic"
    kind = " int8" if args.int8 else " bf16" if args.bf16 else ""
    print(f"exported {args.arch}@{args.image_size}{kind} (batch {b}, {device}) "
          f"-> {args.output} ({os.path.getsize(args.output)} bytes) "
          f"+ {weights} ({os.path.getsize(weights)} bytes)")
    return args.output


if __name__ == "__main__":
    main(build_export_parser().parse_args())
