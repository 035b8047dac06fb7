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
   least time the card could take (its bound): the Gaussian targets (the
   path's three shapes timed, and odd shapes, reaches, peaks and flags), the
   Paeth rotation of the training producer (uint8, and its float32 mode;
   every quarter-turn, the path's extreme slopes and slopes beyond them,
   whose tiles take the kernel's direct walk, sizes 288, 256 and 100, one
   image), the fused pseudo-labels (the three builds of Step B with GT and
   GF alone, every GF kind with and without fusion and normalisation, and
   the largest shapes), and the rotation kernel's two uint16 modes (one
   shear on either axis, the three-shear rotation) on the padded canvas of
   the 288² store, the rotation also at the extreme slopes and beyond them,
   on non-square canvases and at 1 and 5 channels, with two identities
   between the modes;
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
   step of ``make_fused_pretrain_iteration`` (``PoseResNet(resnet101)``);
6. the training CLI, ``dahpe_tpu_torch.cli.train.main``, at full width
   (ResNet-101, 256²/64², batch 32, ``--device-store --with-ema``) on the
   synthetic domains cut to 256 train and 64 val frames: a pretrain epoch
   and a DA epoch with validation, EMA validation, a profiled iteration
   and packed checkpoints; ``--max-steps N`` then ``--resume latest`` to
   2N against a straight 2N run (cuDNN deterministic); ``cli.test`` on
   ``best``; short runs in the host-fed ``--device-aug`` and PIL modes; the
   kernel launches the iteration counts imply; and the save, restore and
   drain-stall times of the full training state.

Then one JSON line of kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import ctypes
import json
import os
import shutil
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
NO_LAUNCHES = {"render_gaussian": 0, "pseudo_labels": 0, "rotate3_fused": 0,
               "rotate3_fused_f32": 0, "rotate3": 0, "shear": 0}
PATH_KERNELS = ("render_gaussian", "pseudo_labels", "rotate3_fused")


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


PORT_KERNELS = ("render_gaussian_kernel", "pseudo_labels_kernel", "rotate3_fused_kernel",
                "rotate3_u16_kernel")


def ptxas_summary(log: str) -> dict[str, str]:
    """``nvcc -Xptxas -v``'s registers, barriers and shared memory per kernel,
    keyed by the mangled name cut to 72 characters."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1][:72]
        elif "Used" in ln and "registers" in ln and name:
            out[name] = ln.split("Used", 1)[1].strip()
    return out


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device busy time (union
    of kernel intervals), the call's wall time, the kernels by time, and the
    device time of each of the port's own kernels."""
    from torch.profiler import ProfilerActivity, profile

    from dahpe_tpu_torch.utils.profiling import device_busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, kernels = device_busy_us(prof.events())
    if not kernels:
        return {"device": "not measured (no CUDA events in the trace)"}
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # summed under the name as printed, so kernels that share the
            # printed prefix add up instead of overwriting each other
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = {k: sum(us for name, us in by_name.items() if k in name) / 1e3
            for k in PORT_KERNELS}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "kernels": kernels,
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
        "ptxas": {name: ptxas_summary(r["log"]) for name, r in records.items()},
    })
    return smi


def gaussian_inputs(torch, b, size, seed, joints=JOINTS, width=None):
    """Peaks with negative and >= size coordinates and ~20% invalid joints."""
    rng = np.random.default_rng(seed)
    width = size if width is None else width
    mu = np.stack([rng.integers(-8, width + 8, size=(b, joints)),
                   rng.integers(-8, size + 8, size=(b, joints))], axis=-1).astype(np.int32)
    valid = (rng.uniform(size=(b, joints)) > 0.2).astype(np.float32)
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
    """A call that launches the kernel file's zero-store yardstick over the
    (B, H, W, K) map ``out`` at the kernel's launch geometry (not counted as
    a kernel launch: it computes nothing of the path)."""
    fn = gaussian._lib().render_gaussian_store_zero_f32
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(out.data_ptr(), *out.shape, stream) != 0:
            raise RuntimeError("store_zero yardstick launch failed")
    return launch


def gaussian_cases(torch):
    """``(name, mu, valid, height, width, reach)`` beyond the path's shapes:
    H != W, an odd W with K = 5 (rows, and the map, not a multiple of 4
    floats), rows shorter than a store, one image, reach 0, a reach above
    the map (inside the kernel's table and beyond it), 512 joints, peaks far
    outside the map, NaN and negative ``valid``."""
    cases = []
    for name, (b, h, w, k, reach) in {
            "H != W": (4, 48, 40, JOINTS, 6), "K = 5, odd W": (3, 17, 31, 5, 4),
            "W K = 3": (2, 5, 3, 1, 1), "B = 1": (1, 64, 64, JOINTS, 6),
            "reach 0": (8, 32, 32, JOINTS, 0), "reach 14 > map": (4, 12, 10, JOINTS, 14),
            "reach 20, beyond the table": (4, 16, 16, JOINTS, 20),
            "K = 512": (2, 24, 20, 512, 5)}.items():
        mu, valid = gaussian_inputs(torch, b, h, seed=len(cases) + 30, joints=k, width=w)
        cases.append((name, mu, valid, h, w, reach))
    rng = np.random.default_rng(40)
    mu = rng.integers(-8, 40, size=(4, JOINTS, 2)).astype(np.int32)
    far = np.array([2**31 - 1, -(2**31) + 2**20, 10**6, -10**6, 40, -7])
    mu.reshape(-1)[::3] = np.resize(far, mu.reshape(-1)[::3].shape)
    cases.append(("far-off peaks", torch.from_numpy(mu).cuda(),
                  torch.ones((4, JOINTS), device="cuda"), 32, 32, 6))
    mu, _ = gaussian_inputs(torch, 4, 32, seed=41)
    odd = np.array([np.nan, -1.0, 0.5, 2.0, 0.0, -0.0, np.inf], dtype=np.float32)
    cases.append(("NaN and negative valid", mu,
                  torch.from_numpy(np.resize(odd, (4, JOINTS))).cuda(), 32, 32, 6))
    return cases


def phase_gaussian(torch, gaussian):
    """Kernel 1 at the path's three shapes, timed beside two yardsticks (zeros
    stored at the kernel's own launch geometry, a PyTorch fill of the same
    bytes), then :func:`gaussian_cases`; each ``torch.equal`` to the plain
    version."""
    launches_before, rows = gaussian.launches, []
    for b, size, reach in GAUSSIAN_SHAPES:
        mu, valid = gaussian_inputs(torch, b, size, seed=size)
        kw = dict(height=size, width=size, sigma=SIGMA, reach=reach)
        got = gaussian.render_gaussian_cuda(mu, valid, **kw)
        ref = gaussian.render_gaussian_plain(mu, valid, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"gaussian {size}²: kernel differs from plain, max abs "
                                 f"{float((got - ref).abs().max())}")
        kernel = lambda: gaussian.render_gaussian_cuda(mu, valid, **kw)  # noqa: E731
        plain = lambda: gaussian.render_gaussian_plain(mu, valid, **kw)  # noqa: E731
        ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        call_ms, plain_call_ms = host_ms(torch, kernel), host_ms(torch, plain)
        store_ms = cuda_ms(torch, store_zero(torch, gaussian, got))
        fill_ms = cuda_ms(torch, lambda: torch.empty_like(got).fill_(0.0))
        bound_ms, bound_by = gaussian_bound_ms(b, size, valid, got)
        rows.append({
            "shape": [b, size, size, JOINTS], "reach": reach, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "over_bound": ms / bound_ms, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "store_ms": store_ms, "fill_ms": fill_ms,
        })
    cases = []
    for name, mu, valid, h, w, reach in gaussian_cases(torch):
        kw = dict(height=h, width=w, sigma=SIGMA, reach=reach)
        got = gaussian.render_gaussian_cuda(mu, valid, **kw)
        ref = gaussian.render_gaussian_plain(mu, valid, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"gaussian {name}: kernel differs from plain")
        cases.append(name)
    line("phase 2 gaussian kernel vs plain (torch.equal)",
         {"shapes": rows, "cases_equal": cases, "launches": gaussian.launches - launches_before})
    return rows[0]


def rotation_bound_ms(b, size, channels, in_bytes=1):
    """Least time for the rotation: the input (uint8, or float32 with
    ``in_bytes=4``) read once and the float32 output written once, against
    its work counted at the float32 rate (the only CUDA-core peak used
    here): per pixel 7 shear lines (subtract, multiply, floor, subtract,
    multiply, round, clamp) and per channel 7 blends (2 multiplies, 2 adds, a
    shift) and the 1/256 scale; a float input adds its conversion (multiply,
    round, 2 clamps) on each of the 8 taps."""
    pixels = b * size * size
    bytes_ms = (pixels * channels * (in_bytes + 4) + b * 12) / HBM_BYTES_PER_S * 1e3
    per_channel = 7 * 5 + 1 + (8 * 4 if in_bytes == 4 else 0)
    ops_ms = pixels * (7 * 7 + channels * per_channel) / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def u16_bound_ms(shape, shears):
    """Least time for ``shears`` (1 or 3) shears of a (B, C, H, W) uint16
    canvas: read once and written once, against 7 operations per shear line
    of a pixel and 5 per blend of a channel at the float32 rate."""
    b, c, h, w = shape
    pixels = b * h * w
    bytes_ms = (2 * pixels * c * 2 + b * 8) / HBM_BYTES_PER_S * 1e3
    lines, blends = (7, 7) if shears == 3 else (1, 1)
    ops_ms = pixels * (lines * 7 + c * blends * 5) / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


A_MAX, B_MAX = float(np.float32(np.tan(np.pi / 8))), float(np.float32(np.sin(np.pi / 4)))


def rotation_case(torch, shear, size, a, b, quarter, seed):
    """One batch of uint8 crops through ``rotate3_fused`` against its plain
    version, then the float32 mode on the same crops as integral floats
    (must equal the uint8 mode) and on non-integral floats beyond both ends
    of [0, 255] (must equal the plain version); returns the tiles that took
    the kernel's direct walk in the uint8 launch."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (len(a), size, size, 3), dtype=torch.uint8, device="cuda",
                           generator=g)
    pad, kmax_a, kmax_b = shear.rotation_geometry(size)
    kw = dict(pad=pad, kmax_a=kmax_a, kmax_b=kmax_b)
    direct = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = shear.rotate3_fused_cuda(images, a, b, quarter, direct_tiles=direct, **kw)
    ref = shear.rotate3_fused_plain(images, a, b, quarter, **kw)
    frac = torch.rand(images.shape, device="cuda", generator=g) * 258.0 - 1.5
    got_int = shear.rotate3_fused_cuda(images.to(torch.float32), a, b, quarter, **kw)
    got_frac = shear.rotate3_fused_cuda(frac, a, b, quarter, **kw)
    ref_frac = shear.rotate3_fused_plain(frac, a, b, quarter, **kw)
    torch.cuda.synchronize()
    where = f"rotate3_fused {size}² x {len(a)}"
    if not torch.equal(got, ref):
        raise AssertionError(f"{where}: kernel differs from plain, max abs "
                             f"{float((got - ref).abs().max())}")
    if not torch.equal(got_int, got):
        raise AssertionError(f"{where}: float32 mode on integral floats differs from uint8")
    if not torch.equal(got_frac, ref_frac):
        raise AssertionError(f"{where}: float32 mode differs from plain, max abs "
                             f"{float((got_frac - ref_frac).abs().max())}")
    return int(direct.item())


def phase_rotate(torch, shear, device_aug):
    """Kernel 3 at the training producer's shape, one batch of 288² uint8
    crops at angles over all four quarter-turns and |r| = 45°, timed (uint8
    and float32 input); then
    the cases of :func:`rotation_case`: the path's extreme slopes (every tile
    staged), slopes beyond them (tiles on the direct walk), sizes 256 and 100,
    one image. Each is ``torch.equal`` to the plain version."""
    launches_before, f32_before = shear.launches, shear.fused_f32_launches
    g = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randint(0, 256, (BATCH, RAW, RAW, 3), dtype=torch.uint8, device="cuda",
                           generator=g)
    angles = torch.linspace(-180.0, 180.0, BATCH, device="cuda")
    angles[:6] = torch.tensor([45.0, -45.0, 135.0, -135.0, 90.0, 0.0])
    quarter, a, b = device_aug.rotation_slopes(angles)
    pad, kmax_a, kmax_b = shear.rotation_geometry(RAW)
    kw = dict(pad=pad, kmax_a=kmax_a, kmax_b=kmax_b)
    direct = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = shear.rotate3_fused_cuda(images, a, b, quarter, direct_tiles=direct, **kw)
    ref = shear.rotate3_fused_plain(images, a, b, quarter, **kw)
    frac = torch.rand(images.shape, device="cuda", generator=g) * 255.0
    got_frac = shear.rotate3_fused_cuda(frac, a, b, quarter, **kw)
    ref_frac = shear.rotate3_fused_plain(frac, a, b, quarter, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"rotate3: kernel differs from plain, max abs "
                             f"{float((got - ref).abs().max())}")
    if not torch.equal(got_frac, ref_frac):
        raise AssertionError("rotate3 float32 mode: kernel differs from plain")
    if int(direct.item()) != 0:
        raise AssertionError(f"rotate3: {int(direct.item())} tiles off the staged path at the "
                             f"path's slopes")
    # the dispatcher launches the float mode for float crops on the card
    if not torch.equal(shear.rotate3_fused(frac, a, b, quarter, **kw), got_frac):
        raise AssertionError("rotate3_fused on float32 crops differs from the float32 mode")

    rows = []
    for crops, in_bytes in ((images, 1), (frac, 4)):
        kernel = lambda: shear.rotate3_fused_cuda(crops, a, b, quarter, **kw)  # noqa: E731
        plain = lambda: shear.rotate3_fused_plain(crops, a, b, quarter, **kw)  # noqa: E731
        bound_ms, bound_by = rotation_bound_ms(BATCH, RAW, 3, in_bytes=in_bytes)
        row = {"shape": [BATCH, RAW, RAW, 3], "dtype": str(crops.dtype).split(".")[-1],
               "quarter_turns": sorted(set(quarter.tolist())), "max_abs_err": 0.0,
               "ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain, iters=10, warmup=2),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "call_ms": host_ms(torch, kernel)}
        row["over_bound"] = row["ms"] / bound_ms
        rows.append(row)

    # the cases: (name, size, a, b, quarter-turns)
    def cycle(n, values):
        return torch.tensor([values[i % len(values)] for i in range(n)], device="cuda")

    q8 = cycle(8, [0, 1, 2, 3]).to(torch.int32)
    extreme = (cycle(8, [A_MAX, -A_MAX, -A_MAX, A_MAX]), cycle(8, [B_MAX, B_MAX, -B_MAX, -B_MAX]))
    beyond = (cycle(8, [0.9, -1.3, 0.6, -0.5]), cycle(8, [1.4, -0.95, -2.0, 1.1]))
    cases = [("path extremes 288²", RAW, *extreme, q8), ("path extremes 256²", 256, *extreme, q8),
             ("path extremes 100²", 100, *extreme, q8),
             ("beyond the caps 288²", RAW, *beyond, q8), ("beyond the caps 100²", 100, *beyond, q8),
             ("one image 288²", RAW, extreme[0][:1], extreme[1][2:3],
              torch.tensor([3], dtype=torch.int32, device="cuda"))]
    direct_tiles = {}
    for i, (name, size, ca, cb, cq) in enumerate(cases):
        direct_tiles[name] = rotation_case(torch, shear, size, ca.float(), cb.float(), cq, 50 + i)
    if any(direct_tiles[name] for name in direct_tiles if "beyond" not in name):
        raise AssertionError(f"rotate3: tiles off the staged path at the path's slopes "
                             f"{direct_tiles}")
    if not all(direct_tiles[name] for name in direct_tiles if "beyond" in name):
        raise AssertionError(f"rotate3: no tile took the direct walk beyond the caps "
                             f"{direct_tiles}")
    line("phase 2 rotate3_fused kernel vs plain (torch.equal), uint8 and float32", {
        "rows": rows, "cases_equal": [c[0] for c in cases],
        "direct_walk_tiles": direct_tiles, "tiles_per_288_batch_of_8": 8 * 9 * 9,
        "stage_capacity_words": shear.stage_capacity(3),
        "launches": {"uint8": shear.launches - launches_before,
                     "float32": shear.fused_f32_launches - f32_before},
    })
    return rows[0], rows[1]


def u16_case(torch, shear, shape, a, b, kmax_a, kmax_b, seed):
    """One full-range uint16 canvas through ``rotate3_cuda`` against
    ``rotate3_plain`` (``torch.equal``); returns the tiles that took the
    kernel's direct walk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    canvas = shear.i32_to_u16(torch.randint(0, 65536, shape, dtype=torch.int32, device="cuda",
                                            generator=g))
    direct = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = shear.rotate3_cuda(canvas, a, b, kmax_a=kmax_a, kmax_b=kmax_b, direct_tiles=direct)
    ref = shear.rotate3_plain(canvas, a, b, kmax_a=kmax_a, kmax_b=kmax_b)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError(f"rotate3 (uint16) {tuple(shape)}: kernel differs from plain")
    return int(direct.item())


def phase_shears(torch, shear):
    """Kernels 5 and 4, the rotation kernel's uint16 modes, at the padded
    canvas of the 288² store (32, 3, 412, 412) with the path's shift bounds,
    full-range values and slopes up to ±tan(22.5°) / ±sin(45°): each shear
    axis and the three-shear rotation against their plain versions (every
    tile of the rotation staged); then the rotation's cases: the path's
    extreme slopes, slopes beyond them (tiles on the direct walk), non-square
    canvases (one of them with rows not a multiple of 4 pixels), 1 and 5
    channels (5 walk every tile directly); then ``rotate3 ==
    shear(shear(shear()))`` and ``crop(rotate3(pad(to_fixed(x)))) / 256 ==
    rotate3_fused(x)`` on the card."""
    pad, kmax_a, kmax_b = shear.rotation_geometry(RAW)
    n = RAW + 2 * pad
    shape = (BATCH, 3, n, n)
    g = torch.Generator(device="cuda").manual_seed(6)
    canvas = shear.i32_to_u16(torch.randint(0, 65536, shape, dtype=torch.int32, device="cuda",
                                            generator=g))
    a = (torch.rand(BATCH, device="cuda", generator=g) * 2 - 1) * 0.41422
    b = (torch.rand(BATCH, device="cuda", generator=g) * 2 - 1) * 0.70711

    def same(x, y):
        return torch.equal(x.view(torch.int16), y.view(torch.int16))

    before = (shear.shear_launches, shear.rotate3_launches)
    rows = {}
    for axis, slope, kmax in ((2, a, kmax_a), (1, b, kmax_b)):
        got = shear.shear_cuda(canvas, slope, kmax=kmax, axis=axis)
        ref = shear.shear_plain(canvas, slope, kmax=kmax, axis=axis)
        torch.cuda.synchronize()
        if not same(got, ref):
            raise AssertionError(f"shear axis {axis}: kernel differs from plain")
        kernel = lambda: shear.shear_cuda(canvas, slope, kmax=kmax, axis=axis)  # noqa: E731
        plain = lambda: shear.shear_plain(canvas, slope, kmax=kmax, axis=axis)  # noqa: E731
        bound_ms, bound_by = u16_bound_ms(shape, 1)
        rows[f"shear_axis{axis}"] = {
            "shape": list(shape), "kmax": kmax, "max_abs_err": 0.0,
            "ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain, iters=10, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    kw = dict(kmax_a=kmax_a, kmax_b=kmax_b)
    direct = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = shear.rotate3_cuda(canvas, a, b, direct_tiles=direct, **kw)
    ref = shear.rotate3_plain(canvas, a, b, **kw)
    torch.cuda.synchronize()
    if not same(got, ref):
        raise AssertionError("rotate3 (uint16): kernel differs from plain")
    if int(direct.item()) != 0:
        raise AssertionError(f"rotate3 (uint16): {int(direct.item())} tiles off the staged path "
                             f"at the path's slopes")
    kernel = lambda: shear.rotate3_cuda(canvas, a, b, **kw)  # noqa: E731
    plain = lambda: shear.rotate3_plain(canvas, a, b, **kw)  # noqa: E731
    bound_ms, bound_by = u16_bound_ms(shape, 3)
    rows["rotate3"] = {"shape": list(shape), "kmax": [kmax_a, kmax_b], "max_abs_err": 0.0,
                       "ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain, iters=10, warmup=2),
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    rows["rotate3"]["over_bound"] = rows["rotate3"]["ms"] / bound_ms

    def cycle(count, values):
        return torch.tensor([values[i % len(values)] for i in range(count)], device="cuda")

    extreme = (cycle(8, [A_MAX, -A_MAX, -A_MAX, A_MAX]), cycle(8, [B_MAX, B_MAX, -B_MAX, -B_MAX]))
    beyond = (cycle(8, [0.9, -1.3, 0.6, -0.5]), cycle(8, [1.4, -0.95, -2.0, 1.1]))
    cases = {"path extremes 412²": ((8, 3, n, n), extreme),
             "beyond the caps 412²": ((8, 3, n, n), beyond),
             "non-square 300 x 412": ((8, 3, 300, n), extreme),
             "non-square 257 x 301": ((8, 3, 257, 301), extreme),
             "beyond the caps 257 x 301": ((8, 3, 257, 301), beyond),
             "1 channel": ((8, 1, n, n), extreme), "5 channels": ((8, 5, 160, 200), extreme)}
    direct_tiles = {}
    for i, (name, (case_shape, (ca, cb))) in enumerate(cases.items()):
        direct_tiles[name] = u16_case(torch, shear, case_shape, ca.float(), cb.float(),
                                      kmax_a, kmax_b, 60 + i)
    staged = [name for name in cases if "beyond" not in name and "5 channels" not in name]
    if any(direct_tiles[name] for name in staged):
        raise AssertionError(f"rotate3 (uint16): tiles off the staged path at the path's slopes "
                             f"{direct_tiles}")
    if not all(direct_tiles[name] for name in cases if name not in staged):
        raise AssertionError(f"rotate3 (uint16): no tile took the direct walk beyond the caps "
                             f"or at 5 channels {direct_tiles}")

    # identities between the modes, on the card
    three = shear.shear_cuda(shear.shear_cuda(shear.shear_cuda(canvas, a, kmax=kmax_a, axis=2),
                                              b, kmax=kmax_b, axis=1), a, kmax=kmax_a, axis=2)
    if not same(got, three):
        raise AssertionError("rotate3 differs from three shear launches")
    crops = torch.randint(0, 256, (BATCH, RAW, RAW, 3), dtype=torch.uint8, device="cuda",
                          generator=g)
    fixed = torch.nn.functional.pad(crops.permute(0, 3, 1, 2).to(torch.int32) * 256,
                                    (pad, pad, pad, pad))
    rotated = shear.rotate3_cuda(shear.i32_to_u16(fixed.contiguous()), a, b, **kw)
    composed = shear.u16_to_i32(rotated)[..., pad:pad + RAW, pad:pad + RAW].to(torch.float32) / 256.0
    zero = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    fused = shear.rotate3_fused_cuda(crops, a, b, zero, pad=pad, **kw)
    if not torch.equal(composed, fused):
        raise AssertionError("crop(rotate3(pad(to_fixed(x)))) / 256 differs from rotate3_fused(x)")
    torch.cuda.synchronize()
    line("phase 2 uint16 shear modes vs plain (torch.equal) and identities", {
        "rows": rows, "identities": {"rotate3 == shear x3": True,
                                     "crop(rotate3(pad(to_fixed)))/256 == rotate3_fused": True},
        "rotate3_cases_equal": list(cases), "rotate3_direct_walk_tiles": direct_tiles,
        "rotate3_tiles_per_412_batch_of_8": 8 * 13 * 13,
        "stage_capacity_words": shear.stage_capacity(3),
        "launches": {"shear": shear.shear_launches - before[0],
                     "rotate3": shear.rotate3_launches - before[1]},
    })
    worst_axis = max(("shear_axis2", "shear_axis1"), key=lambda k: rows[k]["ms"])
    return rows["rotate3"], rows[worst_axis]


def labels_bound_ms(b, size, gf_kind, fused, normalize, gt, joints=JOINTS, with_gt=True):
    """Least time for one label build: peaks (and the fused target) read
    once, GF (and GT) written once, against the float32 work: per element 2
    window compares, ~6 for GF (multiply, subtract, 2 clips), 4 more to fuse
    and 2 to normalize (max, divide); 8 per element this run's peaks put in
    a window (as the Gaussian's bound); the union sum's K adds per pixel."""
    elements = b * size * size * joints
    in_bytes = b * joints * 8 + (elements * 4 if fused else 0)
    bytes_ms = (in_bytes + (2 if with_gt else 1) * elements * 4) / HBM_BYTES_PER_S * 1e3
    per_element = 2 + 6 + (4 if fused else 0) + (2 if normalize else 0)
    ops = elements * per_element + 8 * float((gt > 0).sum())
    if gf_kind != "inverse":
        ops += b * size * size * joints
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def label_case(torch, pseudo_label, batch, size, joints, reach, gf_kind, fused, normalize,
               seed, low=0):
    """One label build through the kernel, with GT and GF alone, against the
    plain version: GT ``torch.equal``, GF within atol 1e-6 (1e-5 with a fused
    target), the GF-only call's GF equal to the full call's. Returns the
    inputs, the keywords, the kernel's (GT, GF) and GF's error."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    peaks = torch.randint(low, size - low, (batch, joints, 2), dtype=torch.int32, device="cuda",
                          generator=g)
    target = None
    if fused:
        target = torch.rand((batch, size, size, joints), device="cuda", generator=g)
    kw = dict(out_size=size, reach=reach, gf_kind=gf_kind, normalize=normalize)
    gt, gf = pseudo_label.pseudo_labels_cuda(peaks, target, **kw)
    none, gf_only = pseudo_label.pseudo_labels_cuda(peaks, target, with_gt=False, **kw)
    gt_ref, gf_ref = pseudo_label.pseudo_labels_plain(peaks, target, **kw)
    torch.cuda.synchronize()
    where = f"labels {batch}x{size}²x{joints} {gf_kind} fused={fused} normalize={normalize}"
    atol = 1e-5 if fused else 1e-6
    err = float((gf - gf_ref).abs().max())
    if not torch.equal(gt, gt_ref):
        raise AssertionError(f"{where}: GT differs from plain")
    if not err <= atol:
        raise AssertionError(f"{where}: GF max abs err {err} > {atol}")
    if none is not None or not torch.equal(gf_only, gf):
        raise AssertionError(f"{where}: the GF-only call differs from the full call")
    return peaks, target, kw, gt, gf, err, atol


def phase_labels(torch, pseudo_label):
    """Kernel 2: the three label builds of Step B (B = 32, K = 21), each with
    GT and GF alone, timed; every GF kind with and without a fused target
    and normalisation at a small shape; the largest shapes, staged (K = 55 at
    90²) and on the second pass (K = 64 at 90²)."""
    launches_before, rows = pseudo_label.launches, []
    for size, reach, gf_kind, fused, normalize in LABEL_SHAPES:
        peaks, target, kw, gt, gf, err, atol = label_case(
            torch, pseudo_label, BATCH, size, JOINTS, reach, gf_kind, fused, normalize, size)
        full = lambda: pseudo_label.pseudo_labels_cuda(peaks, target, **kw)  # noqa: E731
        gf_only = lambda: pseudo_label.pseudo_labels_cuda(  # noqa: E731
            peaks, target, with_gt=False, **kw)
        plain = lambda: pseudo_label.pseudo_labels_plain(peaks, target, **kw)  # noqa: E731
        bound_ms, bound_by = labels_bound_ms(BATCH, size, gf_kind, fused, normalize, gt)
        gf_bound_ms, _ = labels_bound_ms(BATCH, size, gf_kind, fused, normalize, gt,
                                         with_gt=False)
        row = {"shape": [BATCH, size, size, JOINTS], "gf_kind": gf_kind, "fused": fused,
               "normalize": normalize, "max_abs_err": err, "atol": atol,
               "ms": cuda_ms(torch, full), "gf_only_ms": cuda_ms(torch, gf_only),
               "plain_ms": cuda_ms(torch, plain), "bound_ms": bound_ms, "bound_by": bound_by,
               "gf_only_bound_ms": gf_bound_ms, "library_ms": None, "call_ms": host_ms(torch, full)}
        row.update(over_bound=row["ms"] / bound_ms, gf_only_over_bound=row["gf_only_ms"] / gf_bound_ms)
        rows.append(row)

    kinds = []
    for i, gf_kind in enumerate(pseudo_label.GF_KINDS):
        for fused in (False, True):
            for normalize in (False, True):
                *_, err, atol = label_case(torch, pseudo_label, 4, 24, JOINTS, 4, gf_kind, fused,
                                           normalize, 70 + 4 * i + 2 * fused + normalize, low=-3)
                kinds.append({"gf_kind": gf_kind, "fused": fused, "normalize": normalize,
                              "max_abs_err": err, "atol": atol})
    largest = []
    for joints in (55, 64):
        geometry = pseudo_label.launch_geometry(90, joints)
        *_, err, atol = label_case(torch, pseudo_label, 4, 90, joints, 6, "union_minus", True,
                                   True, 90 + joints)
        largest.append({"shape": [4, 90, 90, joints], "staged": geometry["staged"],
                        "shared_bytes": geometry["shared_bytes"], "max_abs_err": err, "atol": atol})
    line("phase 2 pseudo-label kernel vs plain (GT torch.equal, GF atol)", {
        "shapes": rows, "kinds_24x24": kinds, "largest": largest,
        "launches": pseudo_label.launches - launches_before})
    # the path writes GF alone; its 64² build is the largest of an iteration,
    # and the error is the worst of every case
    worst = max([r["max_abs_err"] for r in rows + kinds + largest])
    top = rows[0]
    return dict(top, ms=top["gf_only_ms"], bound_ms=top["gf_only_bound_ms"], max_abs_err=worst)


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
    """The launch counters of the kernel wrappers: name -> (module, counter)."""

    def __init__(self, gaussian, pseudo_label, shear):
        self.counters = {
            "render_gaussian": (gaussian, "launches"),
            "pseudo_labels": (pseudo_label, "launches"),
            "rotate3_fused": (shear, "launches"),
            "rotate3_fused_f32": (shear, "fused_f32_launches"),
            "rotate3": (shear, "rotate3_launches"),
            "shear": (shear, "shear_launches"),
        }

    def reset(self):
        for mod, attr in self.counters.values():
            setattr(mod, attr, 0)

    def read(self):
        return {name: getattr(mod, attr) for name, (mod, attr) in self.counters.items()}


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
    expected = dict(NO_LAUNCHES, render_gaussian=7, pseudo_labels=3, rotate3_fused=2)
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
        "launches_per_iter": {k: v // iters for k, v in launches.items() if v},
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
    if pre_launches != dict(NO_LAUNCHES, render_gaussian=4, rotate3_fused=4):
        raise AssertionError(f"pretrain: launches {pre_launches} for 4 steps")
    if not np.isfinite(float(pm["loss_s"])):
        raise AssertionError("pretrain: non-finite loss")
    line("phase 5b pretrain step resnet101, batch 32", {
        "ms_per_iter": pre_ms, "img_per_s": BATCH * 1e3 / pre_ms,
        "loss_s": float(pm["loss_s"]), "launches": pre_launches,
    })
    return {"launches": {k: v + pre_launches[k] for k, v in launches_all.items()}, "ms": ms,
            "state": state, "fused": fused, "gens": (s_gen, t_gen)}


def phase_checkpoint(torch, trained, root):
    """Save, restore and drain-stall times of the full DA state of phase 5
    (ResNet-101 multi-head model, five momentum partitions, EMA): a
    synchronous packed save and restore, and the fused iteration's ms/iter
    with and without an asynchronous save draining behind it."""
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    state, fused, (s_gen, t_gen) = trained["state"], trained["fused"], trained["gens"]
    path = os.path.join(root, "phase6_state")
    tree = ckpt.state_tree(state)
    nbytes = sum(v.nbytes for _, v in fast_ckpt.flatten_tree(tree))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_state(path, state)
    save_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    step = state.step
    t0 = time.perf_counter()
    ckpt.restore_state(path, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if state.step != step or not all(torch.equal(v, before[k])
                                     for k, v in state.model.state_dict().items()):
        raise AssertionError("checkpoint: the restored state differs from the saved one")

    def iterations(n=5):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _, _, _ = fused(state, s_gen, t_gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    quiet_ms = iterations()
    saver = fast_ckpt.AsyncSaver()
    t0 = time.perf_counter()
    saver.save(path, ckpt.state_tree(state))
    saver.flush()
    drain_idle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saver.save(path, ckpt.state_tree(state))
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    draining_ms = iterations()
    t0 = time.perf_counter()
    saver.flush()
    flush_wait_ms = (time.perf_counter() - t0) * 1e3
    saver.close()
    return {"state_mb": nbytes / 1e6, "save_s": save_s, "restore_s": restore_s,
            "async_drain_s_idle": drain_idle_s, "save_enqueue_ms": enqueue_ms,
            "ms_per_iter_quiet": quiet_ms, "ms_per_iter_while_draining": draining_ms,
            "flush_wait_ms_after_5_iterations": flush_wait_ms}


CLI_TRAIN, CLI_VAL = 256, 64  # frames per synthetic split in phase 6 (default 2048 / 256)
CLI_ARCH, CLI_DEVICE = "resnet101", "cuda"


def phase_cli(torch, kernels, smi, bare_ms, checkpoint):
    """The training CLI end to end on the card (see the module docstring)."""
    from dahpe_tpu_torch import data
    from dahpe_tpu_torch.cli import test as test_cli
    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.data import synthetic
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")

    # the depth of the data is cut, not its width: fewer frames per split
    class Source(synthetic.SyntheticHandsSource):
        def __init__(self, root="", **kw):
            kw.setdefault("n", CLI_VAL if kw.get("split") == "test" else CLI_TRAIN)
            super().__init__(root, **kw)

    class Target(synthetic.SyntheticHandsTarget):
        def __init__(self, root="", **kw):
            kw.setdefault("n", CLI_VAL if kw.get("split") == "test" else CLI_TRAIN)
            super().__init__(root, **kw)

    Source.__name__, Target.__name__ = "SyntheticHandsSource", "SyntheticHandsTarget"
    data.DATASETS.update(SyntheticHandsSource=Source, SyntheticHandsTarget=Target)
    iters, pre_iters, profiled = 8, 8, 1
    val_batches = -(-CLI_VAL // BATCH)

    def argv(log, *extra, mode=("--device-store",)):
        return ["unused", "-s", "SyntheticHandsSource", "-t", "SyntheticHandsTarget",
                "-a", CLI_ARCH, "--device", CLI_DEVICE, "-b", str(BATCH),
                "--image-size", str(IMAGE), "--heatmap-size", str(HEATMAP), *mode,
                "--with-ema", "--print-freq", "100", "--workers", "8", "--seed", "3",
                "--decoded-cache", os.path.join(root, "cache"),
                "--log", os.path.join(root, log), *extra]

    # ms/iter inside the CLI loop: host time between the starts of
    # consecutive fused calls (the launch queue keeps the host within a
    # fraction of an iteration of the card)
    starts = []
    real_fused = train_cli.make_fused_da_iteration

    def timed_fused(*a, **kw):
        call = real_fused(*a, **kw)

        def timed(*args):
            starts.append(time.perf_counter())
            return call(*args)
        return timed

    train_cli.make_fused_da_iteration = timed_fused
    kernels.reset()  # main path 3: the training CLI
    t0 = time.perf_counter()
    try:
        train_cli.main(build_parser("train").parse_args(argv(
            "run", "--pretrain-epochs", "1", "--epochs", "1", "-i", str(iters),
            "--profile", str(profiled))))
    finally:
        train_cli.make_fused_da_iteration = real_fused
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    loop = starts[2 + profiled:]  # after the profile's warm-up and traced calls
    cli_ms = (loop[-1] - loop[0]) * 1e3 / (len(loop) - 1)
    log = os.path.join(root, "run")
    records = [json.loads(r) for r in open(os.path.join(log, "metrics.jsonl"))]
    kinds = [r["kind"] for r in records]
    if kinds != ["pretrain_epoch", "da_epoch"]:
        raise AssertionError(f"cli: metrics kinds {kinds}")
    pck = records[1]["val_target"]["all"]
    if not 0.0 <= pck <= 1.0:
        raise AssertionError(f"cli: target PCK {pck} is not a real PCK")
    for name in ("pretrain", "0", "best", "model_ema", "latest"):
        if not fast_ckpt.is_packed(os.path.join(log, "checkpoints", name)):
            raise AssertionError(f"cli: checkpoint {name} missing")
    with open(os.path.join(log, "trace", "summary.json")) as fh:
        profile = json.load(fh)

    # --max-steps N, then --resume to 2N, against a straight 2N run, from the
    # same warm start; cuDNN deterministic for the comparison
    n = 3
    warm = os.path.join(log, "checkpoints", "pretrain")
    common = ("--pretrain", warm, "--epochs", "2", "-i", "4")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train_cli.main(build_parser("train").parse_args(argv("cut", *common, "--max-steps", str(n))))
        latest = os.path.join(root, "cut", "checkpoints", "latest")
        train_cli.main(build_parser("train").parse_args(argv(
            "cut", *common, "--max-steps", str(2 * n), "--resume", latest)))
        train_cli.main(build_parser("train").parse_args(argv(
            "straight", *common, "--max-steps", str(2 * n))))
        straight = os.path.join(root, "straight", "checkpoints")
        scores = test_cli.main(build_parser("test").parse_args(argv(
            "test", "--checkpoint", os.path.join(straight, "best"))))
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # the host-fed modes: --device-aug (the loader's uint8 crops, from the
    # decoded cache, augmented on the card through the rotation kernel) and
    # PIL (host transforms, targets on the card); host val loaders both
    host_fed = {}
    for name, mode in (("raw", ("--device-aug",)), ("pil", ())):
        t0 = time.perf_counter()
        train_cli.main(build_parser("train").parse_args(argv(
            name, "--pretrain", warm, "--epochs", "1", "-i", "2", mode=mode)))
        torch.cuda.synchronize()
        rec = [json.loads(r) for r in open(os.path.join(root, name, "metrics.jsonl"))][-1]
        if not (rec["kind"] == "da_epoch" and 0.0 <= rec["val_target"]["all"] <= 1.0
                and all(np.isfinite(rec[k]) for k in ("loss_s", "loss_gf", "loss_gt"))):
            raise AssertionError(f"cli {name} mode: {rec}")
        host_fed[name] = {"run_s": time.perf_counter() - t0, "target_pck": rec["val_target"]["all"],
                          "loss_s": rec["loss_s"]}
    torch.cuda.synchronize()
    launches = kernels.read()

    resumed = fast_ckpt.load_packed_tree(latest)
    direct = fast_ckpt.load_packed_tree(os.path.join(straight, "latest"))
    flat_r, flat_d = fast_ckpt.flatten_tree(resumed), fast_ckpt.flatten_tree(direct)
    if [p for p, _ in flat_r] != [p for p, _ in flat_d] or int(resumed["step"]) != 2 * n:
        raise AssertionError("resume: the checkpoints hold different trees or steps")
    unequal, worst = 0, 0.0
    for (path, x), (_, y) in zip(flat_r, flat_d):
        if not torch.equal(x, y):
            unequal += 1
            if x.is_floating_point():
                worst = max(worst, float((x - y).abs().max()))
            if not torch.allclose(x.double(), y.double(), rtol=1e-4, atol=1e-6):
                raise AssertionError(f"resume: {'/'.join(path)} differs from the straight run")
    aux_r, aux_d = ckpt.load_aux(latest), ckpt.load_aux(os.path.join(straight, "latest"))
    if not all(np.array_equal(aux_r[k], aux_d[k]) for k in ("key_s", "key_t")):
        raise AssertionError("resume: the sampling generators did not continue")
    straight_records = [json.loads(r) for r in open(os.path.join(root, "straight", "metrics.jsonl"))]
    best = straight_records[0]["best_target"]
    if abs(scores["target"]["all"] - best) > 1e-6:
        raise AssertionError(f"cli.test on best: PCK {scores['target']['all']} != logged {best}")

    # launches the iteration counts imply: 7/3/2 per DA iteration (no
    # rotation on the PIL path), 1 + 1 per pretrain step, 1 Gaussian per
    # eval batch
    da_iters = (2 + profiled + iters) + n + n + 2 * n + 2 + 2
    rotated_iters = da_iters - 2                       # all but the PIL run's
    eval_batches = (val_batches                        # pretrain epoch, source
                    + 3 * val_batches                  # DA epoch: source, target, EMA
                    + 3 * val_batches * 4              # epoch 0: resumed, straight, raw, PIL
                    + 2 * val_batches)                 # cli.test: source, target
    expected = dict(NO_LAUNCHES, render_gaussian=7 * da_iters + pre_iters + eval_batches,
                    pseudo_labels=3 * da_iters, rotate3_fused=2 * rotated_iters + pre_iters)
    if launches != expected:
        raise AssertionError(f"cli: launches {launches}, expected {expected}")
    # the runs' checkpoints and caches take several GB of disk; the logs,
    # metrics and the trace stay under build/chip_smoke_cli
    for name in os.listdir(root):
        shutil.rmtree(os.path.join(root, name, "checkpoints"), ignore_errors=True)
    for name in ("cache", "phase6_state"):
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    line("phase 6 training CLI resnet101 256²/64², batch 32, --device-store --with-ema", {
        "card": smi, "data_cut": {"train_frames": CLI_TRAIN, "val_frames": CLI_VAL,
                                  "default": [2048, 256]},
        "run_s": run_s, "cli_ms_per_iter": cli_ms, "bare_ms_per_iter_phase5": bare_ms,
        "cli_over_bare": cli_ms / bare_ms, "loop_iterations_timed": len(loop),
        "profile_one_iteration": profile, "target_pck": pck,
        "metrics": {k: records[1][k] for k in ("loss_s", "loss_gf", "loss_gt", "val_source",
                                               "val_target_ema", "best_target")},
        "resume": {"steps": [n, 2 * n], "leaves": len(flat_r), "unequal_leaves": unequal,
                   "max_abs_diff": worst, "bit_identical": unequal == 0,
                   "generators_equal": True, "rtol": 1e-4, "atol": 1e-6},
        "cli_test_best": {"target": scores["target"]["all"], "logged": best},
        "host_fed_modes": host_fed,
        "checkpoint": checkpoint, "launches": launches,
    })
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dahpe_tpu_torch import data, evaluate, models, train
    from dahpe_tpu_torch.data import device_aug
    from dahpe_tpu_torch.ops import _build, gaussian, pseudo_label, shear

    smi = phase_device(torch, _build)
    rows = {"render_gaussian": phase_gaussian(torch, gaussian)}
    rows["rotate3_fused"], rows["rotate3_fused_f32"] = phase_rotate(torch, shear, device_aug)
    rows["pseudo_labels"] = phase_labels(torch, pseudo_label)
    rows["rotate3"], rows["shear"] = phase_shears(torch, shear)
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
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the training path")
        launches[name] += count
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    checkpoint = phase_checkpoint(torch, trained, root)
    bare_ms = trained["ms"]
    del trained
    torch.cuda.empty_cache()
    cli_launches = phase_cli(torch, kernels, smi, bare_ms, checkpoint)
    for name, count in cli_launches.items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the CLI path")
        launches[name] += count

    sources = {
        "render_gaussian": ("render_gaussian.cu", "dahpe_tpu/ops/pallas/gaussian.py:45"),
        "pseudo_labels": ("pseudo_label.cu", "dahpe_tpu/ops/pallas/pseudo_label.py:72"),
        "rotate3_fused": ("rotate3.cu", "dahpe_tpu/ops/pallas/shear.py:164"),
        "rotate3_fused_f32": ("rotate3.cu", "dahpe_tpu/ops/pallas/shear.py:164"),
        "rotate3": ("rotate3.cu", "dahpe_tpu/ops/pallas/shear.py:215"),
        "shear": ("rotate3.cu", "dahpe_tpu/ops/pallas/shear.py:92"),
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
