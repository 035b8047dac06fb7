"""The benchmark's inputs, made from ``--seed``: the model's weights and the
two domains' stored frames. Both sides of the comparison get these same
tensors; the program never makes them.

Weights are drawn on the device in a few large calls (one normal draw for
every convolution, one for the batch-norm and bias entries, one uniform for
the running variances): fan-in scaled convolutions, batch-norm scales
around 1 (the residual branch's last one damped by 0.2), random biases and
running statistics, so the heatmaps have clear peaks from the first step.
Frames are smooth random colour fields with noise, keypoints scattered
around the crop's centre, 90% of them visible.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *purpose.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def make_weights(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict for ``shapes`` (state-dict key -> shape) on ``device``."""
    g = generator(seed, "weights", device)
    out = {}
    conv = [k for k, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in conv), generator=g, device=device)
    at = 0
    for k in conv:
        n, shape = math.prod(shapes[k]), shapes[k]
        out[k] = flat[at:at + n].view(shape).mul_((2.0 / math.prod(shape[1:])) ** 0.5)
        at += n
    normal = [k for k, s in shapes.items() if len(s) == 1 and not k.endswith("running_var")]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in normal), generator=g, device=device)
    at = 0
    for k in normal:
        n = math.prod(shapes[k])
        v = flat[at:at + n]
        at += n
        if k.endswith("running_mean"):
            out[k] = v.mul_(0.5)
        elif k.endswith(".weight"):  # batch-norm scales
            out[k] = v.mul_(0.2).add_(1.0).mul_(0.2 if k.endswith("bn3.weight") else 1.0)
        else:  # batch-norm shifts and convolution biases
            out[k] = v.mul_(0.1)
    var = [k for k in shapes if k.endswith("running_var")]
    flat = torch.rand(sum(math.prod(shapes[k]) for k in var), generator=g, device=device)
    at = 0
    for k in var:
        n = math.prod(shapes[k])
        out[k] = flat[at:at + n].add_(0.5)
        at += n
    for k, s in shapes.items():
        if k not in out:  # num_batches_tracked
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
    return {k: out[k] for k in shapes}  # in state-dict order, as an exported program takes them


def make_frames(seed: int, domain: str, n: int, raw: int, joints: int, device) -> dict:
    """``n`` stored frames of one domain: ``images (n, raw, raw, 3)`` uint8,
    ``kps (n, K, 2)``, ``vis (n, K)``, ``intr (n, 3, 3)`` float32, on ``device``."""
    g = generator(seed, "frames-" + domain, device)
    low = torch.rand((n, 3, 9, 9), generator=g, device=device) * 255.0
    img = F.interpolate(low, size=(raw, raw), mode="bilinear", align_corners=False)
    img = img + 12.0 * torch.randn(img.shape, generator=g, device=device)
    images = img.clamp_(0.0, 255.0).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    kps = (raw / 2.0 + raw / 7.0 * torch.randn((n, joints, 2), generator=g, device=device))
    kps = kps.clamp_(4.0, raw - 4.0)
    vis = (torch.rand((n, joints), generator=g, device=device) < 0.9).to(torch.float32)
    intr = torch.tensor([[300.0, 0.0, raw / 2.0], [0.0, 300.0, raw / 2.0], [0.0, 0.0, 1.0]],
                        device=device).expand(n, 3, 3).contiguous()
    return {"images": images, "kps": kps, "vis": vis, "intr": intr}


class FrameSource:
    """Host copies of :func:`make_frames`, in the protocol a device store
    uploads from (``len``, ``num_keypoints``, ``fetch_raw``)."""

    def __init__(self, frames: dict):
        self.host = {k: v.cpu().numpy() for k, v in frames.items()}
        self.num_keypoints = self.host["kps"].shape[1]

    def __len__(self) -> int:
        return len(self.host["images"])

    def fetch_raw(self, i, rng, raw_size):
        del rng
        if self.host["images"].shape[1] != raw_size:
            raise ValueError(f"frames are {self.host['images'].shape[1]}², not {raw_size}²")
        return {"image_u8": self.host["images"][i], "keypoint2d": self.host["kps"][i],
                "visible": self.host["vis"][i], "intrinsic_matrix": self.host["intr"][i]}
