"""Calibrate the CONTENT shift: the source-only target PCK over a
``(shift, content)`` grid.

Port of ``dahpe_tpu/experiments/content_calibration.py``, beside
:mod:`dahpe_tpu_torch.experiments.adaptation`. The pseudo-label minimax
needs a partly competent source model to bootstrap from, so before a
content-shift acceptance run this measures where one source-only model
lands as a function of the geometry/style ``content`` knob of
``data/synthetic.py``, at each photometric ``shift``. One pretrain, many
evaluations: the source model does not depend on the target's parameters.

    python -m dahpe_tpu_torch.experiments.content_calibration \\
        --shifts 0,0.3 --contents 0.3,0.5,0.7,1.0 --json /tmp/calib.json
"""

from __future__ import annotations

import time

import torch

from dahpe_tpu_torch import resolve_device
from dahpe_tpu_torch.experiments.adaptation import _eval_target, make_backbone


def split_pck(model, dataset, *, batch: int, image_size: int, heatmap_size: int,
              device) -> float:
    """The ``all`` PCK of ``model`` over ``dataset`` uploaded at
    ``image_size`` as a device-resident eval split."""
    from dahpe_tpu_torch.data.device_store import DeviceDataStore
    from dahpe_tpu_torch.evaluate import make_eval_step

    store = DeviceDataStore(dataset, device=device, raw_size=image_size, verbose=False)
    loader = store.eval_loader(batch, heatmap_size=heatmap_size)
    return float(_eval_target(model, loader, dataset, image_size=image_size,
                              heatmap_size=heatmap_size,
                              eval_step=make_eval_step(model, device=device)))


def run_calibration(*, arch: str = "resnet18", n_train: int = 512, n_val: int = 128,
                    image_size: int = 128, heatmap_size: int = 32, batch: int = 32,
                    pre_iters: int = 4000, pretrain_lr: float = 1e-3, rotation: float = 30.0,
                    scale_range=(0.75, 1.25), raw_size: int = 160, shifts=(0.0, 0.3),
                    contents=(0.0, 0.3, 0.5, 0.7, 1.0), style=None, seed: int = 0,
                    bf16: bool = False, device=None, verbose: bool = True) -> dict:
    """Returns ``{"source_val": pck, "grid": [{"shift", "content", "style",
    "pck"}, ...]}``, the JAX package's keys. ``arch`` takes
    ``adaptation.make_backbone``'s names; ``device`` defaults to the card."""
    from dahpe_tpu_torch import models
    from dahpe_tpu_torch.data.device_store import DeviceDataStore
    from dahpe_tpu_torch.data.synthetic import SyntheticHands
    from dahpe_tpu_torch.train import create_pretrain_state, make_fused_pretrain_iteration

    device = resolve_device(device)

    def log(msg):
        if verbose:
            print(msg, flush=True)

    mk = dict(n=n_train, seed=seed, image_size=(image_size,) * 2,
              heatmap_size=(heatmap_size,) * 2)
    src_store = DeviceDataStore(SyntheticHands(domain="source", split="train", **mk),
                                device=device, raw_size=raw_size, verbose=False)
    dtype = torch.bfloat16 if bf16 else None
    torch.manual_seed(seed)
    model = models.PoseResNet(make_backbone(arch, dtype), num_keypoints=21, dtype=dtype)
    state = create_pretrain_state(model, device=device)
    fused = make_fused_pretrain_iteration(model, src_store, batch, image_size=image_size,
                                          heatmap_size=heatmap_size, rotation=rotation,
                                          scale_range=tuple(scale_range))
    gen = src_store.generator(seed + 100)
    t0 = time.time()
    for i in range(pre_iters):
        state, m, gen = fused(state, gen, pretrain_lr)
        if verbose and (i + 1) % 1000 == 0:
            log(f"  pretrain {i + 1}/{pre_iters} loss={float(m['loss_s']):.4f} "
                f"acc_s={float(m['acc_s']):.3f}")
    log(f"pretrain done in {time.time() - t0:.0f}s")

    ev = dict(batch=batch, image_size=image_size, heatmap_size=heatmap_size, device=device)
    mkv = dict(mk, n=n_val)
    src_pck = split_pck(model, SyntheticHands(domain="source", split="test", **mkv), **ev)
    log(f"source-val PCK {src_pck:.3f}")
    grid = []
    for shift in shifts:
        for content in contents:
            pck = split_pck(model, SyntheticHands(domain="target", split="test", shift=shift,
                                                  content=content, style=style, **mkv), **ev)
            grid.append({"shift": float(shift), "content": float(content),
                         "style": float(content if style is None else style), "pck": pck})
            log(f"  shift={shift:<4} content={content:<4} source-only target PCK {pck:.3f}")
    return {"source_val": src_pck, "grid": grid}


if __name__ == "__main__":
    import argparse
    import json

    def _floats(s):
        return tuple(float(x) for x in s.split(",") if x)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--pre-iters", type=int, default=4000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--shifts", type=_floats, default=(0.0, 0.3))
    p.add_argument("--contents", type=_floats, default=(0.0, 0.3, 0.5, 0.7, 1.0))
    p.add_argument("--style", type=float, default=None,
                   help="fixed rendering-style shift; default couples it to each content value")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--json", default=None)
    a = p.parse_args()
    r = run_calibration(arch=a.arch, pre_iters=a.pre_iters, batch=a.batch, shifts=a.shifts,
                        contents=a.contents, style=a.style, seed=a.seed, bf16=a.bf16,
                        device=a.device)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(r, f)
