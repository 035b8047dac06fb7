"""Acceptance experiment: the 3-step DA minimax must BEAT source-only.

Port of ``dahpe_tpu/experiments/adaptation.py``. The reference exists to
produce an adaptation gain: target PCK of the adversarial loop
(``train1.py:328-458``) over plain supervised source training
(``train1.py:278-325``). Step-for-step parity cannot show that gain; this
experiment does, on the asset-free controlled shift of
:mod:`dahpe_tpu_torch.data.synthetic`:

1. pretrain a PoseResNet on labeled SOURCE for ``pre_iters``;
2. CONTROL: a copy of the pretrain state continues source-only training
   for another ``da_iters`` (equal gradient-update budget), evaluate target
   PCK;
3. DA: from the SAME pretrain snapshot (a key-filtered warm start), run
   ``da_iters`` of the fused 3-step minimax with unlabeled target batches,
   evaluate target PCK (and the EMA twin when enabled).

Success = DA beats the control by a clear margin at a non-trivial absolute
level. Everything runs through the production machinery: device-resident
stores, fused iterations (one step per call, as the JAX experiment runs),
the real evaluation loop. The batches come from ``torch.Generator`` streams,
so a seed's run is not the JAX package's run: compare distributions.

Over W devices the experiment is one data-parallel job of W ranks, W by
the JAX package's rule (:func:`rank_count`): the global batch splits
into W equal rank batches drawn from sharded training stores, and every
rank validates on the whole split. Where JAX runs one SPMD program, the
port runs one process a rank (:mod:`dahpe_tpu_torch.parallel`).

    python -m dahpe_tpu_torch.experiments.adaptation --seed 0 --json out.json
"""

from __future__ import annotations

import copy
import math
import time

import torch
import torch.distributed as dist

from dahpe_tpu_torch import parallel, resolve_device


def _eval_target(model, loader, dataset, *, image_size, heatmap_size, eval_step):
    """The ``all`` PCK of ``model`` over ``loader`` (``validate`` takes the
    model, so there are no separate weights to pass)."""
    from dahpe_tpu_torch.evaluate import validate

    return validate(loader, model, dataset, image_size=image_size,
                    heatmap_size=heatmap_size, print_freq=10 ** 9,
                    eval_step=eval_step)["all"]


def make_backbone(arch: str, dtype=None) -> torch.nn.Module:
    """``'mini'``: a [1,1,1,1]-bottleneck ResNet; ``'micro'``: a [1,1,1,1]
    BasicBlock one (stage widths 64..512 without the 4x bottleneck
    expansion, ~20x cheaper than ``'mini'`` end to end); else the named
    backbone of ``models.BACKBONES``."""
    from dahpe_tpu_torch import models

    if arch == "mini":
        return models.ResNet(models.Bottleneck, [1, 1, 1, 1], dtype=dtype)
    if arch == "micro":
        return models.ResNet(models.BasicBlock, [1, 1, 1, 1], dtype=dtype)
    return models.get_backbone(arch, dtype=dtype)


def available_devices(device) -> int:
    """The devices a run on ``device`` takes when ``n_devices`` is None:
    every card of this host for ``cuda``, one for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def rank_count(batch: int, n_devices: int | None, available: int) -> int:
    """The number of ranks of a run: the JAX package's ``gcd(batch,
    n_devices or available)`` (``dahpe_tpu/experiments/adaptation.py:106``),
    so the global batch splits into equal rank batches."""
    return math.gcd(batch, n_devices or available)


def warm_start(da_model: torch.nn.Module, pretrained: dict) -> None:
    """Load the pretrain state dict into the multi-head DA model, key-filtered
    (``utils.torch_import.filtered_update``): backbone and upsampling
    transfer; the pretrain head's keys do not exist there and are dropped."""
    from dahpe_tpu_torch.utils.torch_import import filtered_update

    da_model.load_state_dict(filtered_update(da_model.state_dict(), pretrained))


def run_adaptation_experiment(
    *,
    arch: str = "mini",
    n_train: int = 384,
    n_val: int = 128,
    image_size: int = 64,
    heatmap_size: int = 16,
    batch: int = 16,
    pre_iters: int = 300,
    da_iters: int = 300,
    pretrain_lr: float = 1e-3,
    da_lr: float = 0.01,
    rotation: float = 30.0,
    scale_range=(0.75, 1.25),
    raw_size: int = 96,
    shift: float = 0.4,
    content: float = 0.0,
    style: float | None = None,
    seed: int = 0,
    with_ema: bool = True,
    ema_decay: float = 0.999,
    conf_gate: float | None = None,
    bf16: bool = False,
    eval_every: int = 100,
    n_devices: int | None = 1,
    verbose: bool = True,
    device=None,
) -> dict:
    """Returns ``{"source_only": pck, "da": pck, "gain": …, "curve": […]}``
    and the other keys of the JAX package's result.

    ``arch='mini'`` is a [1,1,1,1]-bottleneck backbone for quick smoke
    runs, ``'micro'`` a [1,1,1,1] BasicBlock one; any name in
    ``models.BACKBONES`` works. The acceptance configuration is the
    ``__main__`` defaults (resnet18 @ 128²/32). ``bf16`` builds every model
    computing in bfloat16 on float32 parameters, as the JAX package's
    ``bf16``. ``device`` defaults to the card.

    ``n_devices`` sets the ranks, W = :func:`rank_count` of ``batch`` and
    ``n_devices`` (None: every card, or one CPU). W = 1 runs in this
    process. Inside a process group (the ``DAHPE_*`` contract or
    ``torchrun``, brought up by ``parallel.robust_distributed_initialize``)
    this process runs as its rank, and W must be the group's size. Else W
    above 1 spawns W ranks (``parallel.run_ranks``; ranks sharing a card
    need ``DAHPE_DIST_BACKEND=gloo``) and returns rank 0's result, which
    every rank must hold; its ``da_seconds`` is rank 0's.
    """
    settings = dict(locals())
    device = resolve_device(device)
    if dist.is_initialized():
        world = parallel.world_size()
        n_dev = rank_count(batch, n_devices, world)
        if n_dev != world:
            raise ValueError(f"n_devices={n_devices} at batch {batch} gives {n_dev} ranks, but "
                             f"the process group has {world}")
        device = parallel.robust_distributed_initialize(device, verbose=False)
    else:
        n_dev = rank_count(batch, n_devices, available_devices(device))
        if n_dev > 1:
            return parallel.run_ranks(run_adaptation_experiment, n_dev, device=device,
                                      kwargs={**settings, "n_devices": n_dev})
    rank = parallel.rank()
    verbose = verbose and rank == 0  # rank 0 alone logs

    from dahpe_tpu_torch import models
    from dahpe_tpu_torch.data.device_store import DeviceDataStore
    from dahpe_tpu_torch.data.synthetic import SyntheticHands
    from dahpe_tpu_torch.evaluate import make_eval_step
    from dahpe_tpu_torch.train import (
        create_da_state,
        create_pretrain_state,
        make_fused_da_iteration,
        make_fused_pretrain_iteration,
    )

    t_start = time.time()

    def log(msg):
        if verbose:
            print(msg, flush=True)

    log(f"adaptation experiment: {device}, {n_dev} rank(s), arch={arch}, "
        f"{pre_iters}+{da_iters} iters, batch {batch}")

    mk = dict(n=n_train, seed=seed, image_size=(image_size,) * 2,
              heatmap_size=(heatmap_size,) * 2)
    src_train = SyntheticHands(domain="source", split="train", **mk)
    tgt_train = SyntheticHands(domain="target", split="train", shift=shift,
                               content=content, style=style, **mk)
    mkv = dict(mk, n=n_val)
    src_val = SyntheticHands(domain="source", split="test", **mkv)
    tgt_val = SyntheticHands(domain="target", split="test", shift=shift,
                             content=content, style=style, **mkv)

    store = dict(device=device, verbose=False)
    # each rank's shard of the training rows; validation stays whole
    src_store = DeviceDataStore(src_train, raw_size=raw_size, shard=(rank, n_dev), **store)
    tgt_store = DeviceDataStore(tgt_train, raw_size=raw_size, shard=(rank, n_dev), **store)
    val_loader = DeviceDataStore(tgt_val, raw_size=image_size, **store).eval_loader(
        batch, heatmap_size=heatmap_size)
    sval_loader = DeviceDataStore(src_val, raw_size=image_size, **store).eval_loader(
        batch, heatmap_size=heatmap_size)

    dtype = torch.bfloat16 if bf16 else None

    aug = dict(image_size=image_size, heatmap_size=heatmap_size,
               rotation=rotation, scale_range=tuple(scale_range))
    evals = dict(image_size=image_size, heatmap_size=heatmap_size)

    # ---- phase 1: supervised source pretrain --------------------------
    torch.manual_seed(seed)
    pre_model = models.PoseResNet(make_backbone(arch, dtype), num_keypoints=21, dtype=dtype)
    pre_state = create_pretrain_state(pre_model, device=device)
    if n_dev > 1:  # every rank drew the same initial weights
        parallel.assert_replicated(pre_state)
    pre_fused = make_fused_pretrain_iteration(pre_model, src_store, batch, **aug,
                                              **parallel.data_parallel(pre_model))
    gen = src_store.generator(seed + 100)
    t0 = time.time()
    for i in range(pre_iters):
        pre_state, m, gen = pre_fused(pre_state, gen, pretrain_lr)
        if verbose and (i + 1) % max(eval_every, 1) == 0:
            log(f"  pretrain {i + 1}/{pre_iters} loss={float(m['loss_s']):.4f} "
                f"acc_s={float(m['acc_s']):.3f}")
    # the snapshot the DA model warm-starts from; the control trains a copy
    pre_vars = {k: v.detach().clone() for k, v in pre_model.state_dict().items()}
    eval_pre = make_eval_step(pre_model, device=device)
    pck_src = _eval_target(pre_model, sval_loader, src_val, eval_step=eval_pre, **evals)
    pck_pretrain = _eval_target(pre_model, val_loader, tgt_val, eval_step=eval_pre, **evals)
    log(f"pretrain done in {time.time() - t0:.0f}s; source-val PCK "
        f"{pck_src:.3f}, target PCK {pck_pretrain:.3f}")

    # ---- control: source-only for the SAME extra budget ----------------
    # (a cross-rank batch norm holds the default group as None: nothing of
    # the process group is copied)
    ctl_state = copy.deepcopy(pre_state)
    ctl_fused = make_fused_pretrain_iteration(ctl_state.model, src_store, batch, **aug,
                                              **parallel.data_parallel(ctl_state.model))
    for i in range(da_iters):
        ctl_state, m, gen = ctl_fused(ctl_state, gen, pretrain_lr)
    pck_source_only = _eval_target(
        ctl_state.model, val_loader, tgt_val,
        eval_step=make_eval_step(ctl_state.model, device=device), **evals)
    log(f"source-only control ({pre_iters}+{da_iters} iters): "
        f"target PCK {pck_source_only:.3f}")

    # ---- DA: the full 3-step minimax from the same pretrain ------------
    torch.manual_seed(seed)
    da_model = models.MultiHeadPoseResNet(make_backbone(arch, dtype), num_keypoints=21,
                                          dtype=dtype)
    warm_start(da_model, pre_vars)
    da_state = create_da_state(da_model, device=device, with_ema=with_ema)
    if n_dev > 1:  # every rank warm-started from the same snapshot
        parallel.assert_replicated(da_state)
    da_fused = make_fused_da_iteration(
        da_model, src_store, tgt_store, batch, base_lr=da_lr,
        ema_decay=ema_decay if with_ema else None, conf_gate=conf_gate, **aug,
        **parallel.data_parallel(da_model),
    )
    ks, kt = src_store.generator(seed + 200), tgt_store.generator(seed + 300)
    eval_da = make_eval_step(da_model, device=device)
    curve = []
    t0 = time.time()
    for i in range(da_iters):
        da_state, m = da_fused(da_state, ks, kt)[:2]
        if (i + 1) % eval_every == 0 or i + 1 == da_iters:
            pck = _eval_target(da_model, val_loader, tgt_val, eval_step=eval_da, **evals)
            curve.append((i + 1, float(pck)))
            log(f"  DA {i + 1}/{da_iters} loss_s={float(m['loss_s']):.4f} "
                f"target PCK {pck:.3f}")
    pck_da = curve[-1][1]
    result = {
        "shift": float(shift),
        "content": float(content),
        "style": float(content if style is None else style),
        "source_val": float(pck_src),
        "pretrain": float(pck_pretrain),
        "source_only": float(pck_source_only),
        "da": float(pck_da),
        "gain": float(pck_da - pck_source_only),
        "curve": curve,
        "da_seconds": time.time() - t0,
    }
    if with_ema:
        ema_model = copy.deepcopy(da_model)
        ema_model.load_state_dict({**da_model.state_dict(), **da_state.ema})
        result["da_ema"] = float(_eval_target(
            ema_model, val_loader, tgt_val, eval_step=make_eval_step(ema_model, device=device),
            **evals))
    if n_dev > 1:  # rank 0's clock, then every rank must hold one result
        seconds = [result["da_seconds"]]
        dist.broadcast_object_list(seconds)
        result["da_seconds"] = seconds[0]
        results = [None] * n_dev
        dist.all_gather_object(results, result)
        if any(r != result for r in results):
            raise AssertionError(f"rank {rank}: the ranks' results differ: {results}")
    log(f"RESULT source_only={result['source_only']:.3f} "
        f"da={result['da']:.3f} gain={result['gain']:+.3f}"
        + (f" ema={result['da_ema']:.3f}" if with_ema else "")
        + f" ({time.time() - t_start:.1f} s in all)")
    return result


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--pre-iters", type=int, default=4000)
    p.add_argument("--da-iters", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--heatmap-size", type=int, default=32)
    p.add_argument("--raw-size", type=int, default=160)
    p.add_argument("--shift", type=float, default=0.4)
    p.add_argument("--content", type=float, default=0.0,
                   help="geometry (pose-distribution) shift strength of "
                        "the target domain (docs/ACCURACY.md content study)")
    p.add_argument("--style", type=float, default=None,
                   help="rendering-style shift strength; default couples "
                        "it to --content")
    p.add_argument("--da-lr", type=float, default=0.01)
    p.add_argument("--ema-decay", type=float, default=0.999,
                   help="EMA twin decay (reference default 0.999, "
                        "train1.py:667; the training CLI's default is 0.99)")
    p.add_argument("--conf-gate", type=float, default=None,
                   help="drop this per-joint fraction of least-confident "
                        "target pseudo-labels in steps B/C (drift "
                        "mitigation; default off = reference behavior)")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype (float32 parameters)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=None,
                   help="also write the result dict to this path")
    a = p.parse_args()
    r = run_adaptation_experiment(
        arch=a.arch, pre_iters=a.pre_iters, da_iters=a.da_iters,
        batch=a.batch, n_train=a.n_train, image_size=a.image_size,
        heatmap_size=a.heatmap_size, raw_size=a.raw_size, shift=a.shift,
        content=a.content, style=a.style, da_lr=a.da_lr,
        ema_decay=a.ema_decay, conf_gate=a.conf_gate,
        eval_every=a.eval_every, bf16=a.bf16, seed=a.seed,
    )
    if a.json:
        with open(a.json, "w") as f:
            json.dump(r, f)
