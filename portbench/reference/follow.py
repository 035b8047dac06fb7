"""The reference followed over a training cell's compared calls.

:func:`follow` rebuilds everything from the seed (the benchmark's weights
and frames, the domains' generators) and runs the plain reference for the
calls the program's set-up compared, recording what the program recorded:
each call's losses (the call's mean over its iterations), every momentum
buffer's norm after the first call, and each tracked entry's change after
the last (parameters, batch-norm statistics, the EMA). ``control`` runs it
in the precision below the configuration's: ``"tf32"`` (TF32 matmuls and
convolutions) or ``"fp8"`` (every convolution's input and weight rounded to
float8 e4m3 with a per-tensor scale, as a scaled fp8 forward rounds them).
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.reference import producer
from portbench.reference.da_step import Reference
from portbench.reference.model import PoseModel

COMPUTE = {"bfloat16": torch.bfloat16, "float32": None}


def build_model(config: dict, dtype=None) -> PoseModel:
    return PoseModel(config["layers"], config["num_keypoints"], config["feature_dim"], dtype)


def state_shapes(config: dict, device) -> dict:
    """The model's state-dict key -> shape, from the reference's own model."""
    with torch.device(device):
        model = build_model(config)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


class _RoundFP8(torch.autograd.Function):
    """Forward: ``t`` rounded to float8 e4m3 under a per-tensor scale;
    backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, t):
        scale = t.abs().amax().float().clamp(min=1e-12) / 448.0
        return (t.float() / scale).to(torch.float8_e4m3fn).float().mul(scale).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(t)


def follow(config: dict, traffic: dict, seed: int, device, calls: int, control: str | None = None,
           fault: str | None = None):
    """The reference over ``calls`` calls of ``traffic['steps_per_call']``
    iterations; returns ``losses (calls, 3)``, ``buffers``, ``changes`` and
    ``first_grads`` (norms by key) on the host. ``fault="half"`` plants a
    fault: each batch's second half left out, the means taken over the rest."""
    k = int(traffic["steps_per_call"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control == "tf32"
    try:
        with torch.device(device):
            model = build_model(config, COMPUTE[config["dtype"]])
        weights = inputs.make_weights(state_shapes(config, device), seed, device)
        model.load_state_dict(weights)
        if control == "fp8":
            model.set_quant(fp8)
        ref = Reference(model, step=traffic["start_step"], ema_decay=traffic["ema_decay"],
                        momentum=traffic["momentum"], weight_decay=traffic["weight_decay"],
                        lr=(traffic["lr"], traffic["lr_gamma"], traffic["lr_decay"]))
        stores = {d: inputs.make_frames(seed, d, config["store_frames"], config["raw_size"],
                                        config["num_keypoints"], device)
                  for d in ("source", "target")}
        gens = {d: inputs.generator(seed, "stream-" + d, device) for d in stores}
        kw = dict(image_size=config["image_size"], heatmap_size=config["heatmap_size"],
                  rotation=traffic["rotation"], scale_range=tuple(traffic["scale_range"]))
        losses, buffers = [], None
        for c in range(calls):
            total = None
            for _ in range(k):
                b_s = producer.batch(stores["source"], gens["source"], traffic["batch"], **kw)
                b_t = producer.batch(stores["target"], gens["target"], traffic["batch"], **kw)
                if fault == "half":
                    half = traffic["batch"] // 2
                    b_s, b_t = ({n: v[:half] for n, v in b.items()} for b in (b_s, b_t))
                step = ref.step_once(b_s, b_t)
                total = step if total is None else total + step
            losses.append(total / k)
            if c == 0:
                named = dict(model.named_parameters())
                buffers = norms({n: ref.buf[id(p)] for n, p in named.items()})
        changes = norms(changes_of(ref.tracked(), ref.ema, weights))
        return {"losses": torch.stack(losses).cpu().double().numpy(), "buffers": buffers,
                "changes": changes, "first_grads": norms(ref.first_grads)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def changes_of(tracked: dict, ema: dict, start: dict) -> dict:
    """Each tracked entry's and EMA entry's difference from ``start``."""
    out = {k: v.detach() - start[k] for k, v in tracked.items()}
    out.update({"ema:" + k: v - start[k] for k, v in ema.items()})
    return out


def norms(tensors: dict) -> dict:
    """Float64 host norms of a dict of tensors, in one copy."""
    keys = list(tensors)
    vals = torch.stack([tensors[k].detach().double().norm() for k in keys]).cpu().numpy()
    return dict(zip(keys, vals.tolist()))
