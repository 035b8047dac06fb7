"""The plain reference of the DA training iteration, in plain PyTorch.

A frozen copy of the published 3-step minimax (``train1.py:355-458`` of the
reference) on :mod:`portbench.reference.model`, written as the reference
writes it: three forward passes a iteration (source; target for Step B;
target again for Step C), the literal losses with labels built from the main
head's argmax peaks in plain PyTorch, five SGD optimizers (Nesterov, coupled
weight decay) over the partitions backbone+upsampling / head / the three
adversarial heads, the reference's lr schedule and GL coefficient, and an
EMA of every parameter and batch-norm statistic. Nothing here imports the
port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.producer import gaussians, peaks

PARTITIONS = {"f": ("backbone", "upsampling"), "h": ("head",), "h_adv": ("head_adv",),
              "h_adv2": ("head_adv2",), "h_adv3": ("head_adv3",)}
ADV = ("h_adv", "h_adv2", "h_adv3")
EPS = 1e-7


def da_lr(step, base_lr=0.01, gamma=1e-4, decay=0.75, optimizer_lr=0.1):
    """The reference's per-iteration lr, in float32 as numpy computes it."""
    factor = (np.float32(1.0) + np.float32(gamma) * np.float32(step)) ** np.float32(-decay)
    return float(np.float32(optimizer_lr * base_lr) * factor)


def gl_coeff(step, device, hi=0.1, max_iters=1000):
    """The GL layer's warm-start coefficient at ``step``, float32 on ``device``."""
    i = torch.tensor(float(step), dtype=torch.float32, device=device)
    return 2.0 * hi / (1.0 + torch.exp(-i / max_iters)) - hi


def kl_loss(output, target, weight, eps=EPS):
    b, h, w, k = output.shape
    logp = torch.log_softmax(output.reshape(b, h * w, k), dim=1)
    t = target.reshape(b, h * w, k) + eps
    t = t / torch.clamp(torch.sum(t, dim=1, keepdim=True), min=1e-12)
    kl = torch.sum(torch.xlogy(t, t) - t * logp, dim=1)
    return torch.mean(kl * weight.reshape(b, k))


def upsample(x, size):
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def _gf(pk, size, reach, kind, fused, normalize):
    gt = gaussians(pk, torch.ones(pk.shape[:2], device=pk.device), size, reach)
    if kind == "union_minus":
        gf = torch.clamp(torch.clamp(gt.sum(dim=-1, keepdim=True), 0.0, 1.0) - gt * 10.0, 0.0, 1.0)
    else:
        gf = torch.clamp(1.0 - gt * 10.0, 0.0, 1.0)
    if fused is not None:
        gf = torch.clamp(gf + fused.to(torch.float32) - gt * 100.0, 0.0, 1.0)
    if normalize:
        gf = gf / torch.clamp(torch.amax(gf, dim=(-3, -2), keepdim=True), min=1e-12)
    return gf


def rd(y, y_adv, pk, weight, scale, mode, fused=None):
    """The disparity of one adversarial head against the main head's peaks:
    toward the peaks' Gaussians ('min') or toward the ground-false mask ('max')."""
    size = y.shape[1] // scale
    reach, kind, norm = {1: (6, "union_minus", True), 2: (4, "inverse", True),
                         4: (3, "inverse", False)}[scale]
    if mode == "min":
        label = gaussians(pk // scale, torch.ones(pk.shape[:2], device=pk.device), size, reach)
    else:
        label = _gf(pk // scale, size, reach, kind, fused, norm)
    return kl_loss(y_adv, label, weight)


class Reference:
    """The model, its five SGDs' momentum, the step count and the EMA."""

    def __init__(self, model, *, step=0, ema_decay=0.99, momentum=0.9, weight_decay=1e-4,
                 lr=(0.01, 1e-4, 0.75)):
        self.model, self.step, self.lr = model.train(), int(step), lr
        self.ema_decay, self.momentum, self.wd = ema_decay, momentum, weight_decay
        self.params = {name: [p for key in keys for p in getattr(model, key).parameters()]
                       for name, keys in PARTITIONS.items()}
        self.buf = {id(p): torch.zeros_like(p) for p in model.parameters()}
        self.ema = {k: v.detach().clone() for k, v in self.tracked().items()}
        self.first_grads = None

    def tracked(self):
        """Every parameter and batch-norm running statistic, by state-dict key."""
        out = dict(self.model.named_parameters())
        out.update({k: v for k, v in self.model.named_buffers()
                    if k.endswith(("running_mean", "running_var"))})
        return out

    @torch.no_grad()
    def _sgd(self, names, lr):
        for name in names:
            for p in self.params[name]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                d = torch.add(g, p, alpha=self.wd)
                buf = self.buf[id(p)]
                buf.mul_(self.momentum).add_(d)
                p.sub_(d.add_(buf, alpha=self.momentum).mul_(lr))

    def _zero(self, names):
        for name in names:
            for p in self.params[name]:
                p.grad = None

    def step_once(self, b_s, b_t):
        """One iteration; returns the three losses as host floats."""
        m, dev = self.model, b_s["image"].device
        lam = gl_coeff(self.step, dev)
        lr = torch.tensor(da_lr(self.step, *self.lr), dtype=torch.float32, device=dev)
        everything = tuple(PARTITIONS)

        self._zero(everything)
        out = m(b_s["image"], lam)
        y = out["y"]
        pk = peaks(y.detach())
        w = b_s["weight"]
        loss_s = (2.0 * kl_loss(y, b_s["target"], w, eps=0.0)
                  + 4.0 * rd(y, out["y_adv2"], pk, w, 2, "min")
                  + 4.0 * rd(y, out["y_adv"], pk, w, 1, "min")
                  + 4.0 * rd(y, out["y_adv3"], pk, w, 4, "min"))
        loss_s.backward()
        if self.first_grads is None:
            self.first_grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
                                for k, p in m.named_parameters()}
        self._sgd(everything, lr)

        w = b_t["weight"]
        self._zero(ADV)
        out = m(b_t["image"], lam)
        y = out["y"].detach()
        pk = peaks(y)
        a3, a2 = out["y_adv3"].detach(), out["y_adv2"].detach()
        t64 = 0.5 * upsample(a3, y.shape[1:3]) + upsample(a2, y.shape[1:3])
        t32 = upsample(a3, out["y_adv2"].shape[1:3])
        loss_gf = (0.3 * rd(y, out["y_adv3"], pk, w, 4, "max")
                   + 1.0 * rd(y, out["y_adv"], pk, w, 1, "max", t64)
                   + 0.3 * rd(y, out["y_adv2"], pk, w, 2, "max", t32))
        loss_gf.backward(inputs=[p for n in ADV for p in self.params[n]])
        self._sgd(ADV, lr)

        self._zero(("f",))
        out = m(b_t["image"], lam)
        y = out["y"].detach()
        pk = peaks(y)
        loss_gt = (0.3 * rd(y, out["y_adv2"], pk, w, 2, "min")
                   + 1.0 * rd(y, out["y_adv"], pk, w, 1, "min"))
        loss_gt.backward(inputs=self.params["f"])
        self._sgd(("f",), lr)

        with torch.no_grad():
            tracked = self.tracked()
            for k, e in self.ema.items():
                e.mul_(self.ema_decay).add_(tracked[k].detach(), alpha=1.0 - self.ema_decay)
        self.step += 1
        return torch.stack([loss_s.detach(), loss_gf.detach(), loss_gt.detach()]).float()
