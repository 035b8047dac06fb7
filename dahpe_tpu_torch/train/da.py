"""The 3-step adversarial domain-adaptation iteration.

Port of ``dahpe_tpu/train/da.py``. Reference hot loop: ``train1.py:355-458``,
per iteration:

  Step A (source):  all five optimizers minimize
                    2·KL(y_s, label) + 4·rd32(min) + 4·rd64(min) + 4·rd16(min)
  Step B (target):  the three adversarial heads maximize disparity against
                    ground-false masks fused with the coarser heads' detached,
                    bilinearly-upsampled heatmaps (``train1.py:408-436``)
  Step C (target):  backbone+upsampling minimize 0.3·rd32(min) + 1·rd64(min),
                    reaching the features only through the λ-scaled GL layer

The step runs on the model's device and never waits for it: the step count
is a device tensor the step advances in place, the learning rate and the GL
coefficient are computed from it on the device, the pseudo-labels are built
from peaks decoded on the device (one decode per main-head heatmap), and the
metrics stay device tensors. No ``.item()``, no copy to the host, no Python
branch on a device value, so one iteration can be captured as a CUDA graph
and replayed (``train/fused.py``).

With the tracer on (``utils.profiling``), Steps A, B and C and the EMA
update with the step's metrics are the phases ``step_a``, ``step_b``,
``step_c`` and ``ema``: host spans that also mark the device's stream, and
a closing marker ends the iteration.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

from dahpe_tpu_torch import resolve_device, set_float32_policy
from dahpe_tpu_torch.core.decode import upsample_bilinear
from dahpe_tpu_torch.core.heatmap import peaks_from_heatmap
from dahpe_tpu_torch.core.losses import joints_kl_loss
from dahpe_tpu_torch.core.metrics import pck_accuracy
from dahpe_tpu_torch.models.batch_norm import BatchNorm2d
from dahpe_tpu_torch.ops.gradient_scale import warm_start_coeff
from dahpe_tpu_torch.train import disparity
from dahpe_tpu_torch.train.ema import ema_state, ema_update
from dahpe_tpu_torch.train.optim import (
    DA_PARTITIONS,
    StepTable,
    da_lr,
    make_partitioned_sgd,
    partition_params,
    step_partitions,
    zero_grad,
)
from dahpe_tpu_torch.utils import profiling

ALL = tuple(DA_PARTITIONS)
ADV = ("h_adv", "h_adv2", "h_adv3")
SHARED_MODULES = ("backbone", "upsampling", "head")  # run once on the target batch


class DATrainState:
    """The model (its parameters and BN statistics), one SGD per partition
    of ``DA_PARTITIONS``, the step count and the optional EMA entries
    (``train.ema.ema_state`` keys).

    The step count is kept twice: ``step_t``, a 0-d int64 tensor on the
    model's device that the step advances in place (the schedules read it,
    so each replay of a captured iteration sees its own step), and
    ``step``, its host mirror, which the caller advances (:meth:`advance`)
    without reading the device. Setting ``step`` sets both."""

    def __init__(self, model: torch.nn.Module, optimizers: dict[str, torch.optim.SGD],
                 step: int = 0, ema: dict[str, torch.Tensor] | None = None):
        self.model, self.optimizers, self.ema = model, optimizers, ema
        device = next(model.parameters()).device
        self.step_t = torch.zeros((), dtype=torch.int64, device=device)
        self.step = step

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self.step_t.fill_(self._step)

    def advance(self, k: int = 1) -> None:
        """Move the host mirror by ``k`` steps the device already took."""
        self._step += k


def create_da_state(
    model: torch.nn.Module,
    *,
    device=None,
    with_ema: bool = False,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
) -> DATrainState:
    """Training state around ``model`` (moved to ``device``, default the
    card) with fresh momentum, step 0 and, with ``with_ema``, an EMA copy of
    its parameters and BN statistics. Sets the port's float32 policy (no
    TF32)."""
    set_float32_policy()
    model.to(resolve_device(device)).train()
    optimizers = make_partitioned_sgd(model, DA_PARTITIONS, momentum=momentum,
                                      weight_decay=weight_decay)
    ema = None
    if with_ema:
        ema = {k: v.detach().clone() for k, v in ema_state(model).items()}
    return DATrainState(model=model, optimizers=optimizers, ema=ema)


def _bn_stats(model: torch.nn.Module, names: tuple[str, ...]) -> list[torch.Tensor]:
    """The running means and variances of the BN layers under ``names``."""
    out = []
    for name in names:
        for mod in getattr(model, name).modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                out += [mod.running_mean, mod.running_var]
    return out


def make_da_train_step(
    model: torch.nn.Module,
    *,
    base_lr: float = 0.01,
    lr_gamma: float = 1e-4,
    lr_decay: float = 0.75,
    trade_off: float = 1.0,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    ema_decay: float | None = None,
    gl_hi: float = 0.1,
    gl_max_iters: int = 1000,
    compute_metrics: bool = True,
    share_target_features: bool = True,
    bn_momentum: float | None = None,
    conf_gate: float | None = None,
    collectives=None,
) -> Callable:
    """Build the DA step ``(state, batch_s, batch_t) -> (state, metrics)``.

    Batches are dicts with ``image (B,H,W,3)``, ``target (B,64,64,K)`` and
    ``weight (B,K)`` on the model's device; the state is updated in place
    and returned. The metrics are 0-d device tensors (``lr`` and
    ``gl_coeff`` too) and, with ``compute_metrics``, the predictions.

    The returned function has two attributes for ``train/fused.py``:
    ``run(state, batch_s, batch_t) -> metrics``, the step without the host
    mirror's advance (what a CUDA graph captures), and ``cover(state, k)``,
    which extends the lr table to the next ``k`` steps and returns True when
    it moved it.

    ``conf_gate=q`` drops, per joint, the fraction ``q`` of the target
    samples whose main-head peak is lowest (a batch quantile with linear
    interpolation, as ``jnp.quantile``) from the losses of Steps B and C.

    ``share_target_features`` (default on): Steps B and C act on the same
    target batch and B steps only the adversarial heads, so the features and
    the main-head heatmap of the target batch are computed once. Step C
    runs the adversarial heads on a detached leaf of the features, takes the
    gradient there and sends it back through the feature graph
    (``f_t.backward(g)``). The BN running stats of the modules that ran once
    are moved as if they ran twice on the same batch:
    ``r2 = (2 - m)·r1 - (1 - m)·r0``. Off, the step is the reference's
    literal three forwards.

    ``collectives`` (a :class:`~dahpe_tpu_torch.parallel.Collectives`, passed
    by ``parallel.make_parallel_da_step``) makes the step one rank of a
    data-parallel job on its rows of the global batch: each partition's
    gradients are averaged over the ranks before its SGD step, the gate's
    quantile is taken over the global batch (the JAX package's data-parallel
    step computes it so, whatever its comment says), and the losses and
    accuracies are global-batch values. The model's batch norm must take
    global statistics too (``models.batch_norm.set_process_group``).
    """
    if bn_momentum is None:
        # the double update holds only for the momentum the BN layers run
        # with; every model of the zoo uses BatchNorm2d's default
        bn_momentum = inspect.signature(BatchNorm2d).parameters["momentum"].default
    keep = 1.0 - bn_momentum
    hyper = dict(momentum=momentum, weight_decay=weight_decay,
                 reduce=None if collectives is None else collectives.grads)
    gather = None if collectives is None else collectives.gather
    adv_params = partition_params(model, sum((DA_PARTITIONS[n] for n in ADV), ()))
    f_params = partition_params(model, DA_PARTITIONS["f"])
    lr_table = StepTable(lambda i: da_lr(i, base_lr=base_lr, gamma=lr_gamma, decay=lr_decay))

    def gated_weight(y, w):
        if not conf_gate:
            return w
        conf = torch.amax(y.detach(), dim=(1, 2)).to(torch.float32)  # (B, K)
        rows = conf if gather is None else gather(conf)  # the global batch
        thr = torch.quantile(rows, conf_gate, dim=0, interpolation="linear")  # (K,)
        mask = (conf >= thr).to(torch.float32)
        return mask if w is None else w * mask

    def step_b_losses(y, peaks, advs, w):
        """The fused ground-false maximization objective (Step B)."""
        a3, a2 = advs["y_adv3"].detach(), advs["y_adv2"].detach()
        hm_full, hm_half = tuple(y.shape[1:3]), tuple(advs["y_adv2"].shape[1:3])
        t64 = 0.5 * upsample_bilinear(a3, hm_full) + upsample_bilinear(a2, hm_full)
        t32 = upsample_bilinear(a3, hm_half)
        l1 = disparity.rd_16(y, advs["y_adv3"], w, "max", peaks=peaks)
        l2 = disparity.rd_64(y, advs["y_adv"], t64, w, "max", peaks=peaks)
        l3 = disparity.rd_32(y, advs["y_adv2"], t32, w, "max", peaks=peaks)
        return trade_off * (0.3 * l1 + 1.0 * l2 + 0.3 * l3)

    def step_c_losses(y, peaks, advs, w):
        """The disparity minimization objective (Step C)."""
        l1 = disparity.rd_32(y, advs["y_adv2"], None, w, "min", peaks=peaks)
        l2 = disparity.rd_64(y, advs["y_adv"], None, w, "min", peaks=peaks)
        return trade_off * (0.3 * l1 + 1.0 * l2)

    def run(state: DATrainState, batch_s: dict, batch_t: dict) -> dict:
        opts = state.optimizers
        device = state.step_t.device
        x_s, label_s, w_s = batch_s["image"], batch_s["target"], batch_s["weight"]
        x_t, label_t, w_t = batch_t["image"], batch_t["target"], batch_t["weight"]
        model.train()

        # ---- Step A: source supervision + min-disparity, all partitions ----
        with profiling.phase("step_a", device):
            lam = warm_start_coeff(state.step_t, hi=gl_hi, max_iters=gl_max_iters)
            lr = lr_table(state.step_t)
            zero_grad(opts, ALL)
            out_s = model(x_s, lam)
            y = out_s["y"]
            peaks = peaks_from_heatmap(y.detach())
            loss_s = (
                2.0 * joints_kl_loss(y, label_s, w_s)
                + 4.0 * disparity.rd_32(y, out_s["y_adv2"], None, w_s, "min", peaks=peaks)
                + 4.0 * disparity.rd_64(y, out_s["y_adv"], None, w_s, "min", peaks=peaks)
                + 4.0 * disparity.rd_16(y, out_s["y_adv3"], w_s, "min", peaks=peaks)
            )
            loss_s.backward()
            step_partitions(opts, ALL, lr, **hyper)

        # ---- Steps B + C over the target batch ----
        if share_target_features:
            with profiling.phase("step_b", device):
                r0 = [t.clone() for t in _bn_stats(model, SHARED_MODULES)]
                f_t = model.features(x_t)
                f_sg = f_t.detach()
                with torch.no_grad():
                    y_t = model.main_head(f_sg)
                peaks_t = peaks_from_heatmap(y_t)
                w_tg = gated_weight(y_t, w_t)

                zero_grad(opts, ADV)
                loss_gf = step_b_losses(y_t, peaks_t, model.adv_heads(f_sg, lam), w_tg)
                loss_gf.backward()
                step_partitions(opts, ADV, lr, **hyper)

            with profiling.phase("step_c", device):
                zero_grad(opts, ("f",))
                leaf = f_t.detach().requires_grad_(True)
                advs_t = model.adv_heads(leaf, lam)
                loss_gt = step_c_losses(y_t, peaks_t, advs_t, w_tg)
                (g_f,) = torch.autograd.grad(loss_gt, leaf)
                f_t.backward(g_f)
                step_partitions(opts, ("f",), lr, **hyper)
                out_t = {"y": y_t, **advs_t}

                # the shared modules ran once, but the reference's running
                # stats advanced twice with identical batch statistics:
                # r1 = (1-m)·r0 + m·s  ⇒  r2 = (2-m)·r1 - (1-m)·r0
                with torch.no_grad():
                    r1 = _bn_stats(model, SHARED_MODULES)
                    torch._foreach_mul_(r1, 1.0 + keep)
                    torch._foreach_add_(r1, r0, alpha=-keep)
        else:
            with profiling.phase("step_b", device):
                zero_grad(opts, ADV)
                out_b = model(x_t, lam)
                y_b = out_b["y"].detach()
                loss_gf = step_b_losses(y_b, peaks_from_heatmap(y_b), out_b,
                                        gated_weight(y_b, w_t))
                loss_gf.backward(inputs=adv_params)
                step_partitions(opts, ADV, lr, **hyper)

            with profiling.phase("step_c", device):
                zero_grad(opts, ("f",))
                out_t = model(x_t, lam)
                y_c = out_t["y"].detach()
                loss_gt = step_c_losses(y_c, peaks_from_heatmap(y_c), out_t,
                                        gated_weight(y_c, w_t))
                loss_gt.backward(inputs=f_params)
                step_partitions(opts, ("f",), lr, **hyper)

        with profiling.phase("ema", device):
            if ema_decay is not None and state.ema is not None:
                ema_update(state.ema, ema_state(model), ema_decay)

            metrics = {
                "loss_s": loss_s.detach(),
                "loss_gf": loss_gf.detach(),
                "loss_gt": loss_gt.detach(),
                "lr": lr,
                "gl_coeff": lam,
            }
            if collectives is not None:  # global-batch means, one all-reduce
                names = ("loss_s", "loss_gf", "loss_gt")
                metrics.update(zip(names, collectives.mean(
                    torch.stack([metrics[n] for n in names])).unbind()))
            if compute_metrics:
                with torch.no_grad():
                    kw = dict(gather=gather)
                    _, acc_s, _, pred_s = pck_accuracy(out_s["y"].detach(), label_s, **kw)
                    _, acc_t, _, pred_t = pck_accuracy(out_t["y"].detach(), label_t, **kw)
                    _, acc_s_adv, _, _ = pck_accuracy(out_s["y_adv"].detach(), label_s, **kw)
                    _, acc_t_adv, _, _ = pck_accuracy(out_t["y_adv"].detach(), label_t, **kw)
                metrics.update(acc_s=acc_s, acc_t=acc_t, acc_s_adv=acc_s_adv,
                               acc_t_adv=acc_t_adv, pred_s=pred_s, pred_t=pred_t)
            state.step_t.add_(1)
        profiling.mark_end(device)
        return metrics

    def cover(state: DATrainState, k: int) -> bool:
        return lr_table.cover(state.step + k, state.step_t.device)

    def train_step(state: DATrainState, batch_s: dict, batch_t: dict):
        cover(state, 1)
        metrics = run(state, batch_s, batch_t)
        state.advance(1)
        return state, metrics

    train_step.run, train_step.cover = run, cover
    return train_step

