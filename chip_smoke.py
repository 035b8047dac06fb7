#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dahpe_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA card and ``nvcc``; it
exits non-zero without printing a result when either is missing, or when
the ``dahpe_tpu_torch`` package is not beside it. Phases, each printing one
line, fail the run by raising:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (one ``nvcc`` per library, all started together);
2. every CUDA kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with its time, the plain time and the
   least time the card could take (its bound): the Gaussian targets, the
   Paeth rotation of the training producer and the fused pseudo-labels;
3. serving: ``MultiHeadPoseResNet(resnet101)`` at full width (256² frames,
   64² heatmaps, 21 joints) with seeded random weights answers uint8
   requests of 1, 8 and 32 frames through ``make_predict_fn``, checked
   against the same model on the CPU;
4. validation: ``validate`` over a device-resident split of 80 seeded
   frames at batch 32, one Gaussian-kernel launch per eval batch, with the
   same PCK as a run whose targets the plain version renders;
5. DA training: ``make_fused_da_iteration`` (store gather, augmentation,
   targets, the three-step minimax step, EMA) for the full-width model at
   batch 32 per domain from two seeded 288² stores, timed and profiled, with
   each kernel's launches per iteration checked; one iteration from the same
   weights and draws with the kernels and again with their plain versions
   must give bit-identical batches and agreeing losses and weights; then one
   step of ``make_fused_pretrain_iteration`` (``PoseResNet(resnet101)``).

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
RAW, BATCH = 288, 32  # stored crop side; batch per domain (cli/args.py:34)
# (size, reach, gf_kind, fused target, normalize): the labels of Step B
LABEL_SHAPES = [(64, 6, "union_minus", True, True), (32, 4, "inverse", True, True),
                (16, 3, "inverse", False, False)]
LIBRARIES = {"render_gaussian": ["render_gaussian.cu"], "pseudo_label": ["pseudo_label.cu"],
             "rotate3": ["rotate3.cu"]}


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


PORT_KERNELS = ("render_gaussian_kernel", "pseudo_labels_kernel", "rotate3_fused_kernel")


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device busy time (union
    of kernel intervals), the call's wall time, the kernels by time, and the
    device time of each of the port's own kernels."""
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
            # summed under the name as printed, so kernels that share the
            # printed prefix add up instead of overwriting each other
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0) + e.time_range.elapsed_us()
    if not spans:
        return {"device": "not measured (no CUDA events in the trace)"}
    busy, last = 0, None
    for a, b in sorted(spans):
        a = a if last is None else max(a, last)
        if b > a:
            busy += b - a
        last = b if last is None else max(last, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = {k: sum(us for name, us in by_name.items() if k in name) / 1e3
            for k in PORT_KERNELS}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "kernels": len(spans),
            "top_ms": {name: us / 1e3 for name, us in top}, "port_kernels_ms": ours}


def phase_device(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_all(LIBRARIES)
    records = {name: build.build_record(name) for name in LIBRARIES}
    line("phase 1 device", {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_build_s": round(time.perf_counter() - t0, 3),
        "nvcc_s": {name: round(r["seconds"], 3) for name, r in records.items()},
        "ptxas": {name: [ln for ln in r["log"].splitlines() if "registers" in ln]
                  for name, r in records.items()},
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


def rotation_bound_ms(b, size, channels):
    """Least time for the rotation: the uint8 input read once and the
    float32 output written once, against its work counted at the float32
    rate (the only CUDA-core peak used here): per pixel 7 shear
    lines (subtract, multiply, floor, subtract, multiply, round, clamp) and
    per channel 7 blends (2 multiplies, 2 adds, a shift) and the 1/256 scale."""
    pixels = b * size * size
    bytes_ms = (pixels * channels * (1 + 4) + b * 12) / HBM_BYTES_PER_S * 1e3
    ops_ms = pixels * (7 * 7 + channels * (7 * 5 + 1)) / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_rotate(torch, shear, device_aug):
    """Kernel 3 at the training producer's shape: one batch of 288² uint8
    crops, angles over all four quarter-turns and |r| = 45°."""
    launches_before = shear.launches
    g = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randint(0, 256, (BATCH, RAW, RAW, 3), dtype=torch.uint8, device="cuda",
                           generator=g)
    angles = torch.linspace(-180.0, 180.0, BATCH, device="cuda")
    angles[:6] = torch.tensor([45.0, -45.0, 135.0, -135.0, 90.0, 0.0])
    quarter, a, b = device_aug.rotation_slopes(angles)
    pad, kmax_a, kmax_b = shear.rotation_geometry(RAW)
    kw = dict(pad=pad, kmax_a=kmax_a, kmax_b=kmax_b)
    got = shear.rotate3_fused_cuda(images, a, b, quarter, **kw)
    ref = shear.rotate3_fused_plain(images, a, b, quarter, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"rotate3: kernel differs from plain, max abs "
                             f"{float((got - ref).abs().max())}")
    kernel = lambda: shear.rotate3_fused_cuda(images, a, b, quarter, **kw)  # noqa: E731
    plain = lambda: shear.rotate3_fused_plain(images, a, b, quarter, **kw)  # noqa: E731
    ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain, iters=10, warmup=2)
    bound_ms, bound_by = rotation_bound_ms(BATCH, RAW, 3)
    row = {"shape": [BATCH, RAW, RAW, 3], "quarter_turns": sorted(set(quarter.tolist())),
           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "call_ms": host_ms(torch, kernel)}
    line("phase 2 rotate3 kernel vs plain (torch.equal)",
         dict(row, launches=shear.launches - launches_before))
    return row


def labels_bound_ms(b, size, gf_kind, fused, normalize, gt):
    """Least time for one label build: peaks (and the fused target) read
    once, GT and GF written once, against the float32 work: per element 2
    window compares, ~6 for GF (multiply, subtract, 2 clips), 4 more to fuse
    and 2 to normalize (max, divide); 8 per element this run's peaks put in
    a window (as the Gaussian's bound); the union sum's K adds per pixel."""
    elements = b * size * size * JOINTS
    in_bytes = b * JOINTS * 8 + (elements * 4 if fused else 0)
    bytes_ms = (in_bytes + 2 * elements * 4) / HBM_BYTES_PER_S * 1e3
    per_element = 2 + 6 + (4 if fused else 0) + (2 if normalize else 0)
    ops = elements * per_element + 8 * float((gt > 0).sum())
    if gf_kind != "inverse":
        ops += b * size * size * JOINTS
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_labels(torch, pseudo_label):
    """Kernel 2 at the three label builds of Step B (B = 32, K = 21)."""
    launches_before, rows = pseudo_label.launches, []
    for size, reach, gf_kind, fused, normalize in LABEL_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(size)
        peaks = torch.randint(0, size, (BATCH, JOINTS, 2), dtype=torch.int32, device="cuda",
                              generator=g)
        target = None
        if fused:
            target = torch.rand((BATCH, size, size, JOINTS), device="cuda", generator=g)
        kw = dict(out_size=size, reach=reach, gf_kind=gf_kind, normalize=normalize)
        gt, gf = pseudo_label.pseudo_labels_cuda(peaks, target, **kw)
        gt_ref, gf_ref = pseudo_label.pseudo_labels_plain(peaks, target, **kw)
        torch.cuda.synchronize()
        atol = 1e-5 if fused else 1e-6
        err = float((gf - gf_ref).abs().max())
        if not torch.equal(gt, gt_ref):
            raise AssertionError(f"labels {size}²: GT differs from plain")
        if not err <= atol:
            raise AssertionError(f"labels {size}²: GF max abs err {err} > {atol}")
        kernel = lambda: pseudo_label.pseudo_labels_cuda(peaks, target, **kw)  # noqa: E731
        plain = lambda: pseudo_label.pseudo_labels_plain(peaks, target, **kw)  # noqa: E731
        bound_ms, bound_by = labels_bound_ms(BATCH, size, gf_kind, fused, normalize, gt)
        rows.append({"shape": [BATCH, size, size, JOINTS], "gf_kind": gf_kind, "fused": fused,
                     "normalize": normalize, "max_abs_err": err, "atol": atol,
                     "ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "call_ms": host_ms(torch, kernel)})
    line("phase 2 pseudo-label kernel vs plain (GT torch.equal, GF atol)",
         {"shapes": rows, "launches": pseudo_label.launches - launches_before})
    # the 64² build is the largest of an iteration; the error is the worst
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


def flops_by_part(torch, models) -> dict[str, int]:
    """Estimated forward FLOPs (2 per multiply-add) of one frame through
    each part of the model, ``features`` (backbone + deconvolutions), the
    main ``head`` and the three ``adv`` heads, from the layer shapes of every
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
    parts = {}
    with torch.no_grad():
        f = model.features(torch.empty(1, IMAGE, IMAGE, 3, device="meta"))
        parts["features"], macs[:] = 2 * sum(macs), []
        model.main_head(f)
        parts["head"], macs[:] = 2 * sum(macs), []
        model.adv_heads(f)
        parts["adv"] = 2 * sum(macs)
    for h in hooks:
        h.remove()
    return parts


def flops_per_frame(torch, models) -> int:
    """Estimated FLOPs of one frame through the serving path (features, then
    the main head): see :func:`flops_by_part`."""
    parts = flops_by_part(torch, models)
    return parts["features"] + parts["head"]


def flops_per_da_iteration(torch, models, batch: int) -> int:
    """Estimated FLOPs of one DA iteration (shared target features), a
    backward pass counted as twice its forward: Step A runs the whole model
    forward and back on the source batch; the target batch runs the features
    forward and back once, the main head forward once, and the adversarial
    heads forward and back twice (Steps B and C)."""
    p = flops_by_part(torch, models)
    source = 3 * (p["features"] + p["head"] + p["adv"])
    target = 3 * p["features"] + p["head"] + 2 * 3 * p["adv"]
    return batch * (source + target)


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


class Kernels:
    """The launch counters of the three kernel wrappers."""

    def __init__(self, gaussian, pseudo_label, shear):
        self.mods = {"render_gaussian": gaussian, "pseudo_labels": pseudo_label,
                     "rotate3_fused": shear}

    def reset(self):
        for mod in self.mods.values():
            mod.launches = 0

    def read(self):
        return {name: mod.launches for name, mod in self.mods.items()}


def plain_kernels(gaussian, pseudo_label, shear):
    """Swap each dispatcher for its plain version (CUDA tensors included);
    returns the undo."""
    saved = (gaussian.render_gaussian, pseudo_label.pseudo_labels, shear.rotate3_fused)
    gaussian.render_gaussian = lambda mu, valid, **kw: gaussian.render_gaussian_plain(
        mu, valid, **kw)
    pseudo_label.pseudo_labels = lambda peaks, fused=None, **kw: \
        pseudo_label.pseudo_labels_plain(peaks, fused, **kw)
    shear.rotate3_fused = lambda images, a, b, q, **kw: shear.rotate3_fused_plain(
        images, a, b, q, **kw)

    def undo():
        gaussian.render_gaussian, pseudo_label.pseudo_labels, shear.rotate3_fused = saved
    return undo


def snapshot(torch, state):
    """Everything a DA iteration changes: weights, BN stats, momentum, EMA,
    step (to rerun one iteration from the same point)."""
    return {
        "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
        "opt": {n: copy.deepcopy(o.state_dict()) for n, o in state.optimizers.items()},
        "ema": {k: v.clone() for k, v in state.ema.items()} if state.ema else None,
        "step": state.step,
    }


def restore(torch, state, snap):
    with torch.no_grad():
        state.model.load_state_dict(snap["model"])
        for name, opt in state.optimizers.items():
            opt.load_state_dict(copy.deepcopy(snap["opt"][name]))
        if snap["ema"] is not None:
            for k, v in state.ema.items():
                v.copy_(snap["ema"][k])
    state.step = snap["step"]


def phase_training(torch, models, train, data, kernels, smi):
    """The full-width DA iteration (and one pretrain step) on the card."""
    import warnings

    from dahpe_tpu_torch.ops import gaussian, pseudo_label, shear

    t0 = time.perf_counter()
    stores = [data.DeviceDataStore(SyntheticSplit(256, RAW, seed=seed), device="cuda",
                                   raw_size=RAW, verbose=False) for seed in (2, 3)]
    model = build_model(torch, models, seed=9).cuda()
    state = train.create_da_state(model, device="cuda", with_ema=True)
    fused = train.make_fused_da_iteration(model, stores[0], stores[1], BATCH,
                                          share_target_features=True, ema_decay=0.99)
    s_gen, t_gen = stores[0].generator(11), stores[1].generator(12)
    setup_s = time.perf_counter() - t0

    for _ in range(2):  # warm-up: cuDNN picks its algorithms
        state, metrics, s_gen, t_gen = fused(state, s_gen, t_gen)
    torch.cuda.synchronize()
    iters = 5
    kernels.reset()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics, s_gen, t_gen = fused(state, s_gen, t_gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    launches = kernels.read()
    expected = {"render_gaussian": 7, "pseudo_labels": 3, "rotate3_fused": 2}
    if launches != {k: v * iters for k, v in expected.items()}:
        raise AssertionError(f"training: launches {launches} for {iters} iterations, "
                             f"expected {expected} each")
    losses = {k: float(metrics[k]) for k in ("loss_s", "loss_gf", "loss_gt")}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"training: non-finite losses {losses}")

    # host syncs in one iteration, as torch's sync debug mode reports them
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, metrics, s_gen, t_gen = fused(state, s_gen, t_gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0][:120] for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    profile = device_profile(torch, lambda: fused(state, s_gen, t_gen))
    launches_all = kernels.read()

    # the same iteration through the plain label/rotation/Gaussian versions
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    snap = snapshot(torch, state)
    gen_states = (s_gen.get_state(), t_gen.get_state())
    src = stores[0].traced_batch_fn(BATCH)
    tgt = stores[1].traced_batch_fn(BATCH)
    step = train.make_da_train_step(model, share_target_features=True, ema_decay=0.99)
    runs = []
    for use_plain in (False, True):
        restore(torch, state, snap)
        s_gen.set_state(gen_states[0])
        t_gen.set_state(gen_states[1])
        undo = plain_kernels(gaussian, pseudo_label, shear) if use_plain else (lambda: None)
        try:
            b_s, b_t = src(s_gen), tgt(t_gen)
            _, m = step(state, b_s, b_t)
        finally:
            undo()
        runs.append(({**b_s, **{"t_" + k: v for k, v in b_t.items()}},
                     {k: float(m[k]) for k in ("loss_s", "loss_gf", "loss_gt")},
                     {k: v.detach().clone() for k, v in model.state_dict().items()}))
    torch.backends.cudnn.deterministic = cudnn
    (kb, kl, kw), (pb, pl, pw) = runs
    if not all(torch.equal(kb[k], pb[k]) for k in kb):
        raise AssertionError("training: kernel and plain batches differ")
    loss_rel = max(abs(kl[k] - pl[k]) / abs(pl[k]) for k in kl)
    worst_abs, worst_rel = 0.0, 0.0
    for k, v in kw.items():
        if not v.is_floating_point():
            continue
        d = (v - pw[k]).abs()
        worst_abs = max(worst_abs, float(d.max()))
        big = pw[k].abs() > 1e-6
        if bool(big.any()):
            worst_rel = max(worst_rel, float((d[big] / pw[k].abs()[big]).max()))
        if not torch.allclose(v, pw[k], rtol=1e-4, atol=1e-7):
            raise AssertionError(f"training: {k} differs between kernel and plain runs")
    if not loss_rel <= 1e-4:
        raise AssertionError(f"training: losses differ by {loss_rel} between kernel and plain")

    flops = flops_per_da_iteration(torch, models, BATCH)
    if "device_busy_ms" in profile:
        profile.update(est_flop_per_iter=flops,
                       est_flop_per_s_busy=flops / (profile["device_busy_ms"] / 1e3),
                       est_share_of_fp32_peak=flops / (profile["device_busy_ms"] / 1e3)
                       / FP32_OPS_PER_S)
    line("phase 5 DA training resnet101 256²/64²/21, batch 32+32, 288² stores", {
        "card": smi, "setup_s": setup_s, "ms_per_iter": ms,
        "img_per_s": 2 * BATCH * 1e3 / ms, "iterations": iters, "losses": losses,
        "launches_per_iter": {k: v // iters for k, v in launches.items()},
        "host_syncs": syncs, "profile": profile,
        "est_flop_per_iter": flops, "est_flop_per_s": flops / (ms / 1e3),
        "kernel_vs_plain": {"batches_equal": True, "loss_max_rel": loss_rel,
                            "weights_max_abs": worst_abs, "weights_max_rel": worst_rel,
                            "rtol": 1e-4, "atol": 1e-7},
    })

    # the supervised pretrain path (PoseResNet) from the same store
    pose = models.PoseResNet(models.resnet101(), num_keypoints=JOINTS).cuda()
    pstate = train.create_pretrain_state(pose, device="cuda")
    pre = train.make_fused_pretrain_iteration(pose, stores[0], BATCH)
    p_gen = stores[0].generator(13)
    kernels.reset()
    pstate, pm, p_gen = pre(pstate, p_gen, 0.001)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        pstate, pm, p_gen = pre(pstate, p_gen, 0.001)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3 / 3
    pre_launches = kernels.read()
    if pre_launches != {"render_gaussian": 4, "pseudo_labels": 0, "rotate3_fused": 4}:
        raise AssertionError(f"pretrain: launches {pre_launches} for 4 steps")
    if not np.isfinite(float(pm["loss_s"])):
        raise AssertionError("pretrain: non-finite loss")
    line("phase 5b pretrain step resnet101, batch 32", {
        "ms_per_iter": pre_ms, "img_per_s": BATCH * 1e3 / pre_ms,
        "loss_s": float(pm["loss_s"]), "launches": pre_launches,
    })
    return {"launches": {k: v + pre_launches[k] for k, v in launches_all.items()}, "ms": ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dahpe_tpu_torch import data, evaluate, models, train
    from dahpe_tpu_torch.data import device_aug
    from dahpe_tpu_torch.ops import _build, gaussian, pseudo_label, shear

    smi = phase_device(torch, _build)
    rows = {"render_gaussian": phase_gaussian(torch, gaussian),
            "rotate3_fused": phase_rotate(torch, shear, device_aug),
            "pseudo_labels": phase_labels(torch, pseudo_label)}
    model = build_model(torch, models).cuda()
    kernels = Kernels(gaussian, pseudo_label, shear)

    kernels.reset()  # main path 1: serving, then validation
    phase_serving(torch, evaluate, models, model, smi)
    phase_validation(torch, evaluate, gaussian, data, model)
    launches = kernels.read()
    if launches["render_gaussian"] == 0:
        raise AssertionError("render_gaussian kernel never launched on the eval path")
    del model
    kernels.reset()  # main path 2: DA training
    trained = phase_training(torch, models, train, data, kernels, smi)
    for name, count in trained["launches"].items():
        if count == 0:
            raise AssertionError(f"{name} kernel never launched on the training path")
        launches[name] += count

    sources = {
        "render_gaussian": ("render_gaussian.cu", "dahpe_tpu/ops/pallas/gaussian.py:45"),
        "pseudo_labels": ("pseudo_label.cu", "dahpe_tpu/ops/pallas/pseudo_label.py:72"),
        "rotate3_fused": ("rotate3.cu", "dahpe_tpu/ops/pallas/shear.py:164"),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"dahpe_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": None,
    } for name, (src, replaces) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
