#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dahpe_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA card and ``nvcc``; it
exits non-zero without printing a result when either is missing, or when
the ``dahpe_tpu_torch`` package is not beside it. Phases, each printing one
line, fail the run by raising:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. every CUDA kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with its time, the plain time and the
   least time the card could take (its bound);
3. serving: ``MultiHeadPoseResNet(resnet101)`` at full width (256² frames,
   64² heatmaps, 21 joints) with seeded random weights answers uint8
   requests of 1, 8 and 32 frames through ``make_predict_fn``, checked
   against the same model on the CPU;
4. validation: ``validate`` over a device-resident split of 80 seeded
   frames at batch 32, one Gaussian-kernel launch per eval batch, with the
   same PCK as a run whose targets the plain version renders.

Then one JSON line of kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import ctypes
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
IMAGE, HEATMAP, JOINTS, SIGMA = 256, 64, 21, 2.0
GAUSSIAN_SHAPES = [(32, 64, 6), (32, 32, 4), (32, 16, 3)]  # (B, size, reach)


def line(tag: str, payload) -> None:
    print(f"{tag}: {json.dumps(payload)}", flush=True)


def cuda_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls
    queued behind a ~50 ms device sleep, so the card runs them back to back
    and the host's launch rate is not what is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int = 100) -> float:
    """Mean wall time of one call of ``fn`` in ms, synchronized, warm."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device busy time (union
    of kernel intervals), the call's wall time and the kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    if not spans:
        return {"device": "not measured (no CUDA events in the trace)"}
    busy, last = 0, None
    for a, b in sorted(spans):
        a = a if last is None else max(a, last)
        if b > a:
            busy += b - a
        last = b if last is None else max(last, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "kernels": len(spans),
            "top_ms": {name[:60]: us / 1e3 for name, us in top}}


def phase_device(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load("render_gaussian", ["render_gaussian.cu"])
    record = build.build_record("render_gaussian")
    line("phase 1 device", {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_build_s": round(time.perf_counter() - t0, 3),
        "nvcc_s": round(record["seconds"], 3),
        "ptxas": [ln for ln in record["log"].splitlines() if "registers" in ln],
    })
    return smi


def gaussian_inputs(torch, b, size, seed):
    """Peaks with negative and >= size coordinates and ~20% invalid joints."""
    rng = np.random.default_rng(seed)
    mu = rng.integers(-8, size + 8, size=(b, JOINTS, 2)).astype(np.int32)
    valid = (rng.uniform(size=(b, JOINTS)) > 0.2).astype(np.float32)
    return torch.from_numpy(mu).cuda(), torch.from_numpy(valid).cuda()


def gaussian_bound_ms(b, size, valid, got):
    """Least time for the op: each input read once and the output written
    once over the memory rate, against the float32 work over the float32
    rate: 2 compares per output element of a valid joint, and 8 more
    (2 subtracts, 2 multiplies, add, convert, divide, exp) per element this
    run's peaks put inside a window."""
    out_bytes = b * size * size * JOINTS * 4
    in_bytes = b * JOINTS * (2 * 4 + 4)
    bytes_ms = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3
    ops = 2 * float(valid.sum()) * size * size + 8 * float((got > 0).sum())
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def store_zero(torch, gaussian, out):
    """A call that launches the kernel file's zero-store yardstick over
    ``out`` (not counted as a kernel launch: it computes nothing of the path)."""
    fn = gaussian._lib().render_gaussian_store_zero_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(out.data_ptr(), out.numel(), stream) != 0:
            raise RuntimeError("store_zero yardstick launch failed")
    return launch


def phase_gaussian(torch, gaussian):
    launches_before, rows = gaussian.launches, []
    for b, size, reach in GAUSSIAN_SHAPES:
        mu, valid = gaussian_inputs(torch, b, size, seed=size)
        kw = dict(height=size, width=size, sigma=SIGMA, reach=reach)
        got = gaussian.render_gaussian_cuda(mu, valid, **kw)
        ref = gaussian.render_gaussian_plain(mu, valid, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got == 0, ref == 0):
            raise AssertionError(f"gaussian {size}²: zero pattern differs")
        err = float((got - ref).abs().max())
        if not err <= 1e-6:
            raise AssertionError(f"gaussian {size}²: max abs err {err} > 1e-6")
        kernel = lambda: gaussian.render_gaussian_cuda(mu, valid, **kw)  # noqa: E731
        plain = lambda: gaussian.render_gaussian_plain(mu, valid, **kw)  # noqa: E731
        ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        call_ms, plain_call_ms = host_ms(torch, kernel), host_ms(torch, plain)
        # yardsticks, not the same function: zeros written at the kernel's own
        # launch geometry, and a PyTorch fill of the same bytes
        store_ms = cuda_ms(torch, store_zero(torch, gaussian, got))
        fill_ms = cuda_ms(torch, lambda: torch.empty_like(got).fill_(0.0))
        bound_ms, bound_by = gaussian_bound_ms(b, size, valid, got)
        rows.append({
            "shape": [b, size, size, JOINTS], "reach": reach, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "store_ms": store_ms, "fill_ms": fill_ms,
        })
    line("phase 2 gaussian kernel vs plain (tolerance 1e-6, same zeros)",
         {"shapes": rows, "launches": gaussian.launches - launches_before})
    # the main path renders 64² targets; the error is the worst of the scales
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def build_model(torch, models, seed: int = 7):
    """Full-width ResNet-101 multi-head model with fan-in-scaled random
    weights and random BN stats (as ``tests/test_full_model_parity.py``)."""
    model = models.MultiHeadPoseResNet(models.resnet101(), num_keypoints=JOINTS)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=g) * (2.0 / fan_in) ** 0.5)
            elif name.endswith(".weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, mod in model.named_modules():
            if name.endswith("bn3"):
                mod.weight.mul_(0.2)
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.5)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
    return model.eval()


def flops_per_frame(torch, models) -> int:
    """Estimated FLOPs (2 per multiply-add) of one frame through the serving
    path (features, then the main head), from the layer shapes of every
    convolution and deconvolution; the model runs on the meta device, so
    nothing is computed. Elementwise work (BN, ReLU, adds) is left out."""
    model = models.MultiHeadPoseResNet(models.resnet101(), num_keypoints=JOINTS)
    model = model.to("meta").eval()
    macs = []

    def count(mod, inputs, out):
        taps = (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            # each input element scatters into out_channels × kh × kw outputs
            taps = (mod.out_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
            macs.append(inputs[0].numel() * taps)
        else:
            macs.append(out.numel() * taps)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        model.main_head(model.features(torch.empty(1, IMAGE, IMAGE, 3, device="meta")))
    for h in hooks:
        h.remove()
    return 2 * sum(macs)


def phase_serving(torch, evaluate, models, model, smi):
    predict = evaluate.make_predict_fn(
        model, image_size=IMAGE, heatmap_size=HEATMAP, uint8_input=True
    )
    rng = np.random.default_rng(0)
    results, requests = {}, {}
    for n, reps in ((1, 30), (8, 20), (32, 10)):
        frames = requests[n] = rng.integers(0, 256, size=(n, IMAGE, IMAGE, 3), dtype=np.uint8)
        coords, maxvals = predict(frames)  # warm-up: cuDNN picks algorithms
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            coords, maxvals = predict(frames)
            coords, maxvals = coords.cpu(), maxvals.cpu()  # the response
            times.append((time.perf_counter() - t0) * 1e3)
        if tuple(coords.shape) != (n, JOINTS, 2) or tuple(maxvals.shape) != (n, JOINTS, 1):
            raise AssertionError(f"serving: shapes {coords.shape} {maxvals.shape}")
        if not (torch.isfinite(coords).all() and torch.isfinite(maxvals).all()):
            raise AssertionError("serving: non-finite output")
        ms = float(np.mean(times))
        results[n] = {"ms_per_request": ms, "p50_ms": float(np.median(times)),
                      "img_per_s": n * 1e3 / ms, "requests": reps}

    # reference: the same weights on the CPU, two frames
    frames = rng.integers(0, 256, size=(2, IMAGE, IMAGE, 3), dtype=np.uint8)
    x = (torch.from_numpy(frames).float() / 255.0 - torch.tensor([0.485, 0.456, 0.406])) \
        / torch.tensor([0.229, 0.224, 0.225])
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        y_ref = cpu_model.main_head(cpu_model.features(x))
        y_gpu = model.main_head(model.features(x.cuda())).cpu()
    err = float((y_gpu - y_ref).abs().max())
    atol = max(2e-4, 1e-4 * float(y_ref.abs().std()))
    if not torch.allclose(y_gpu, y_ref, rtol=2e-3, atol=atol):
        raise AssertionError(f"serving: card vs CPU heatmaps differ, max abs {err}")
    coords, _ = predict(frames)
    cpu_coords, _ = evaluate.make_predict_fn(
        cpu_model, image_size=IMAGE, heatmap_size=HEATMAP, uint8_input=True, device="cpu"
    )(frames)
    flat = y_ref.reshape(2, -1, JOINTS)
    top2 = flat.topk(2, dim=1).values
    prominent = (top2[:, 0] - top2[:, 1]) > 1e-4
    if not torch.equal(coords.cpu()[prominent], cpu_coords[prominent]):
        raise AssertionError("serving: decoded coordinates differ from the CPU run")
    profile32 = device_profile(torch, lambda: [t.cpu() for t in predict(requests[32])])
    flops = flops_per_frame(torch, models)
    if "device_busy_ms" in profile32:
        rate = 32 * flops / (profile32["device_busy_ms"] / 1e3)
        profile32.update(est_flop_per_frame=flops, est_flop_per_s_busy=rate,
                         est_share_of_fp32_peak=rate / FP32_OPS_PER_S)
    line("phase 3 serving resnet101 256²/64²/21 uint8", {
        "card": smi, "requests": results, "profile_32": profile32,
        "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
        "vs_cpu": {"max_abs_err": err, "atol": atol, "rtol": 2e-3,
                   "prominent_joints": int(prominent.sum())},
    })
    return results


class SyntheticSplit:
    """Seeded uint8 frames and keypoints in the store's ``fetch_raw`` protocol."""

    num_keypoints = JOINTS

    def __init__(self, n, size, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
        self.kps = rng.uniform(-0.05 * size, 1.05 * size, size=(n, JOINTS, 2)).astype(np.float32)
        self.vis = (rng.uniform(size=(n, JOINTS)) > 0.15).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def fetch_raw(self, i, rng, raw_size):
        return {"image_u8": self.images[i], "keypoint2d": self.kps[i],
                "visible": self.vis[i], "intrinsic_matrix": np.eye(3, dtype=np.float32)}


def phase_validation(torch, evaluate, gaussian, data, model):
    store = data.DeviceDataStore(SyntheticSplit(80, IMAGE, seed=1), device="cuda",
                                 raw_size=IMAGE, verbose=False)
    loader = store.eval_loader(32, heatmap_size=HEATMAP, sigma=SIGMA)
    dataset = data.Hand21KeypointDataset()
    before = gaussian.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = evaluate.validate(loader, model, dataset, print_freq=1000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = gaussian.launches - before
    if launched != len(loader):
        raise AssertionError(f"validation: {launched} kernel launches for {len(loader)} batches")

    kernel_render = gaussian.render_gaussian
    gaussian.render_gaussian = lambda mu, valid, **kw: gaussian.render_gaussian_plain(
        mu, valid, **kw)
    try:
        plain_acc = evaluate.validate(loader, model, dataset, print_freq=1000)
    finally:
        gaussian.render_gaussian = kernel_render
    if acc != plain_acc:
        raise AssertionError(f"validation: PCK {acc} != plain-rendered {plain_acc}")
    if not all(np.isfinite(v) and -1.0 <= v <= 1.0 for v in acc.values()):
        raise AssertionError(f"validation: PCK out of range {acc}")
    profile = device_profile(
        torch, lambda: evaluate.validate(loader, model, dataset, print_freq=1000))
    line("phase 4 validation 80 frames, batch 32", {
        "pck": acc, "batches": len(loader), "kernel_launches": launched,
        "seconds": seconds, "img_per_s": store.n / seconds, "profile": profile,
    })


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dahpe_tpu_torch import data, evaluate, models
    from dahpe_tpu_torch.ops import _build, gaussian

    smi = phase_device(torch, _build)
    g = phase_gaussian(torch, gaussian)
    model = build_model(torch, models).cuda()

    gaussian.launches = 0  # main path: serving, then validation
    phase_serving(torch, evaluate, models, model, smi)
    phase_validation(torch, evaluate, gaussian, data, model)
    launches = gaussian.launches
    if launches == 0:
        raise AssertionError("render_gaussian kernel never launched on the main path")

    print(json.dumps({"kernels": [{
        "name": "render_gaussian",
        "route": "cuda",
        "source": "dahpe_tpu_torch/csrc/render_gaussian.cu",
        "replaces": "dahpe_tpu/ops/pallas/gaussian.py:45",
        "launches": launches,
        "max_abs_err": g["max_abs_err"],
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
