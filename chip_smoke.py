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
   three shapes of each path's heatmap size, 64 and 96, timed, and odd
   shapes, reaches, peaks and flags), the Paeth rotation of the training
   producer (uint8, and its float32 mode; every quarter-turn, the path's
   extreme slopes and slopes beyond them, whose tiles take the kernel's
   direct walk, sizes 288, 256 and 100, one image), the fused pseudo-labels
   (the three builds of Step B with GT and GF alone, GF alone also on the
   general kernel, those of a run at ``--heatmap-size 96`` and the maps
   128² and 256², every GF kind with and without fusion and normalisation,
   joint groups up to K = 600, and the largest
   shapes), and the rotation kernel's two uint16 modes (one shear on either
   axis, the three-shear rotation) on the padded canvas of the 288² store,
   both also at the extreme slopes and beyond them, on non-square canvases
   and at 1 and 5 channels (the shear also at one image, a shift bound past
   the canvas, canvases at odd addresses and a tall one whose ShY windows
   pass their cap), with two identities between the modes;
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
   and one DA iteration at ``--image-size 384 --heatmap-size 96`` (the label
   kernel at 96²), its launches and finite losses checked;
6. the training CLI, ``dahpe_tpu_torch.cli.train.main``, at full width
   (ResNet-101, 256²/64², batch 32, ``--device-store --with-ema``) on the
   synthetic domains cut to 256 train and 64 val frames: a pretrain epoch
   and a DA epoch with validation, EMA validation, a profiled iteration
   and packed checkpoints; ``--max-steps N`` then ``--resume latest`` to
   2N against a straight 2N run (cuDNN deterministic); ``cli.test`` on
   ``best``; short runs in the host-fed ``--device-aug`` and PIL modes; the
   kernel launches the iteration counts imply; and the save, restore and
   drain-stall times of the full training state;
7. the serving deployment path: phase 3's model exported with
   ``torch.export`` as a batch-polymorphic uint8-ingest float artifact and
   as an int8 artifact (calibrated on seeded frames, bfloat16 glue), each
   served by ``cli.serve``'s ``create_server`` on the loopback with
   ``--batch-window 2`` (one CUDA graph per padded batch) and asked for 1, 8
   and 32 frames through ``PoseClient`` and by 16 concurrent single-frame
   clients; checked: float coordinates against phase 3's predict, graph
   replay against eager execution, ``torch._int_mm`` against a float64
   convolution at every conv of ResNet-101, int8 heatmaps within 0.1·std
   of the float ones, fewer dispatches than requests under the burst; then
   ``cli.export`` of phase 6's ``best`` and ``cli.test --artifact``, whose
   PCK must equal ``cli.test --checkpoint``'s exactly;
8. ``steps_per_call`` as CUDA-graph replays and the adaptation experiment:
   (a) the DA iteration at phase 5's configuration and the pretrain
   iteration, each from one snapshot run as 4 eager single calls and as one
   graphed 4-step call (cuDNN deterministic for the check): the generators
   ``torch.equal`` and every weight, BN statistic, momentum and EMA entry
   within the DA parity tolerance (rtol 5e-3), the three path kernels
   counted per replay by the profiler against one eager iteration, and
   ms/iter at K = 1, 4 and 8, idle shares and peak memory; (b) the training
   CLI at phase 6's configuration with ``--steps-per-call 4``:
   ``--max-steps 4`` then ``--resume`` to 8 against a straight run; (c) the
   adaptation experiment at its acceptance configuration (resnet18 at
   128²/32², shift 0.3, content 0.3, style 1.0, EMA 0.99, confidence gate
   0.5, seed 0) cut to 200 + 200 iterations, every number finite;
9. the bfloat16 compute dtype (``--bf16``): (a) phase 5's DA iteration with
   a bfloat16 model (float32 parameters): 7 / 3 / 2 path-kernel launches per
   eager iteration, the float32 parameters moved and finite, bfloat16
   heatmaps, the kernel iteration against the plain-kernel one from one
   snapshot (phase 5's tolerances: rtol 1e-4 / atol 1e-7 on the weights,
   1e-4 on the losses), the device profile (busy time, idle share, top operations,
   time by kind, FLOP/s against the bfloat16 dense peak) and the fused
   target's cast to float32, then phase 8a's graph check (a
   replayed chunk bit for bit equal to 4 eager calls whenever two eager runs
   are) with ms/iter at K = 1, 4 and 8; (b) the pretrain iteration the same
   way; (c) phase 3's model exported by ``cli.export --bf16 --uint8-input``
   and served in process and over HTTP at 1, 8 and 32 frames: the served
   coordinates equal the bfloat16 eager predict's, and equal the float32
   predict's wherever the float32 heatmap's top-2 gap exceeds twice the
   bfloat16 heatmap's deviation from it; (d) phase 8b's CLI run with
   ``--bf16`` (``--max-steps 4`` / ``--resume`` to 8 bit for bit equal to a
   straight run), then ``cli.test --bf16`` on its ``best``, which must
   score the PCK the run logged (0 at 8 iterations); (e) phase 8c's cut
   acceptance in bfloat16, whose trained DA model's target PCK must lie
   within 0.05 of a float32 twin's on the same weights;
10. data parallelism: (a) the data-parallel DA iteration
   (``make_fused_da_iteration`` with ``parallel.data_parallel``'s
   collectives) at world size 1 over NCCL in this process, at phase 5's
   configuration: with cuDNN deterministic, and noise floors (the same runs
   twice) that must be bit for bit, 2 iterations bit for bit equal to the
   iteration without a group, and a K = 4 graph with the collectives
   captured bit for bit equal to 4 eager calls; ms/iter at K = 1 and 4,
   NCCL's device time, the collective calls an iteration issues and its
   host syncs, 7 / 3 / 2 path kernels per eager iteration and as kernel
   nodes of the captured graph (read from its DOT dump; the profiler's
   count of a replay is reported beside them); (b) two ranks sharing the card over gloo
   (``DAHPE_DIST_BACKEND=gloo``; NCCL refuses two ranks on one device),
   each a process of this script (``--worker``), one DA iteration at global
   batch 32 + 32 (each rank's 16 + 16 rows from its store shard) against
   the same iteration at world 1: losses within rel 1e-4, every parameter
   within 1e-4 and every BN statistic within twice the float64 floor (world
   1 in float64 against world 1 in float32 on the same draws; also
   reported against the ranks and on the global batch of 4 ranks' draws),
   all 373 parameters equal across the ranks, 7 / 3 / 2 launches a rank,
   ms/iter and the collectives' share;
   (c) ``cli.train --multihost --device-store`` over the two ranks on phase
   6's cut data: a pretrain epoch and a DA epoch cut by ``--max-steps``, in
   which SIGTERM to rank 1 alone drains both ranks at one step, rank 0
   alone writes, and ``--resume`` ends bit for bit where a straight run
   ends (each rank's sampling states from the sidecar); (d) ``cli.serve
   --mesh`` on phase 7's float artifact: the coordinates at 1, 8 and 32
   frames equal the server's without it;
11. the rest of the JAX package's paths: (a) ``cli.train --host-warp`` at
   full width (float32) on phase 6's cut data: the native library's build
   (``g++``), one batch of its fused augmentation against the numpy
   version, the warped loader's img/s on 8 threads, a pretrain and a DA
   epoch with ms/iter in the loop, a profiled iteration's idle share and
   the launches the counts imply (7 / 3 / 0 a DA iteration); (b)
   ``experiments.perf_audit`` at phase 5's configuration in float32 and
   bf16: each stage's device ms from CUDA-graph replays, the stages' sum
   within 10% of the whole producer's, the rotation and Gaussian launches
   the warm-up calls and captures imply;
   (c) ``experiments.preempt_drill`` through the CLI (this script's
   ``--cli-train``: phase 6's cut domains) at full width, bf16: SIGTERM
   mid-epoch, exit 0, the resume at the exact iteration, every epoch's
   checkpoint, the two processes' launches; (d) ``RegDAPoseResNet(
   resnet101)``'s eval outputs for 1 and 32 frames on the card against
   the CPU at phase 3's tolerance;
12. the adaptation experiment over two ranks sharing the card over gloo,
   spawned by ``parallel.run_ranks``, at the acceptance configuration
   (resnet18, 128²/32², global batch 32, 512 + 128 frames a domain, shift
   0.3, content 0.3, style 1.0, EMA 0.99, gate 0.5): (a) 2 + 2 + 2
   iterations against one process on the same global draws, cuDNN
   deterministic: losses within rel 1e-4, the DA and EMA states within
   10b's bounds against their own float64 floor, the five PCKs within
   0.01, one result and equal states on both ranks, each rank's launches
   those the iterations imply; (b) 50 + 50 + 50 iterations at W = 2 and
   W = 1: ms per DA iteration, the collectives' share, launches per rank.

Then one JSON line of kernels, and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py --cards

runs, on a machine with several cards, what needs them all: phase 1's
build, 10d over every card on a float artifact it exports, and 10b and
12 with one rank per card over NCCL (12 at the experiment's rank count,
gcd(32, cards)). It ends with the same last line.
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
BF16_OPS_PER_S = 989e12  # H100 SXM bfloat16 tensor cores, dense
BF16_EVAL_PCK_TOL = 0.05  # phase 9e: bf16 vs float32 target PCK on one model's weights
IMAGE, HEATMAP, JOINTS, SIGMA = 256, 64, 21, 2.0
GAUSSIAN_SHAPES = [(32, 64, 6), (32, 32, 4), (32, 16, 3)]  # (B, size, reach)
GAUSSIAN_SHAPES_96 = [(32, 96, 6), (32, 48, 4), (32, 24, 3)]  # at --heatmap-size 96
RAW, BATCH = 288, 32  # stored crop side; batch per domain (cli/args.py:34)
# (size, reach, gf_kind, fused target, normalize): the labels of Step B
LABEL_SHAPES = [(64, 6, "union_minus", True, True), (32, 4, "inverse", True, True),
                (16, 3, "inverse", False, False)]
LIBRARIES = {"render_gaussian": ["render_gaussian.cu"], "pseudo_label": ["pseudo_label.cu"],
             "rotate3": ["rotate3.cu"]}
NO_LAUNCHES = {"render_gaussian": 0, "pseudo_labels": 0, "rotate3_fused": 0,
               "rotate3_fused_f32": 0, "rotate3": 0, "shear": 0}
PATH_KERNELS = ("render_gaussian", "pseudo_labels", "rotate3_fused")
# the path kernels' device names, as a profile lists them
PATH_KERNEL_NAMES = ("render_gaussian_kernel", "pseudo_labels_kernel", "rotate3_fused_kernel")


_START = time.perf_counter()


def line(tag: str, payload: dict) -> None:
    """One phase's line, with the seconds since the script started."""
    payload = dict(payload, elapsed_s=round(time.perf_counter() - _START, 1))
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
# kernel kinds, by the first kind whose marker a kernel's printed name
# holds: NCCL's collectives, the port's kernels, cuDNN's NCHW <-> NHWC conversions, batch norm,
# convolutions and GEMMs (cuDNN, CUTLASS, cuBLAS), the multi-tensor
# (foreach) SGD and EMA passes; "other" is the remaining elementwise and
# reduction work
KERNEL_KINDS = (("collective", ("nccl",)), ("port", PORT_KERNELS), ("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("batch_norm", ("batch_norm", "bn_")),
                ("convolution", ("xmma", "cutlass", "cudnn", "conv", "gemm", "dgrad", "wgrad")),
                ("foreach", ("multi_tensor_apply",)))


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


def device_profile(torch, fn, n_top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device busy time (union
    of kernel intervals), the call's wall time, the ``n_top`` kernels by time,
    and the device time of each of the port's own kernels."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    ours = {k: sum(us for name, us in by_name.items() if k in name) / 1e3
            for k in PORT_KERNELS}
    counts = {k: sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and k in e.name)
              for k in PORT_KERNELS}
    kinds = {}
    for name, us in by_name.items():
        kind = next((k for k, marks in KERNEL_KINDS if any(m in name for m in marks)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "kernels": kernels,
            "top_ms": {name: us / 1e3 for name, us in top}, "by_kind_ms": kinds,
            "port_kernels_ms": ours, "port_kernel_launches": counts}


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
    """Kernel 1 at the path's three shapes and the three of a run at
    ``--heatmap-size 96``, timed beside two yardsticks (zeros stored at the
    kernel's own launch geometry, a PyTorch fill of the same bytes), then
    :func:`gaussian_cases`; each ``torch.equal`` to the plain version."""
    launches_before, rows = gaussian.launches, []
    for b, size, reach in GAUSSIAN_SHAPES + GAUSSIAN_SHAPES_96:
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
         {"shapes": rows[:len(GAUSSIAN_SHAPES)], "heatmap_96": rows[len(GAUSSIAN_SHAPES):],
          "cases_equal": cases, "launches": gaussian.launches - launches_before})
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


def shear_case(torch, shear, shape, slope, kmax, axis, seed, offset=0):
    """One full-range uint16 canvas through ``shear_cuda`` against
    ``shear_plain`` (``torch.equal``); ``offset`` puts the canvas that many
    elements into its buffer (rows at other phases of the 8-byte words).
    Returns the ShY tiles that took the direct walk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    flat = shear.i32_to_u16(torch.randint(0, 65536, (n + offset,), dtype=torch.int32,
                                          device="cuda", generator=g))
    canvas = flat[offset:].view(shape)
    direct = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = shear.shear_cuda(canvas, slope, kmax=kmax, axis=axis, direct_tiles=direct)
    ref = shear.shear_plain(canvas, slope, kmax=kmax, axis=axis)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError(f"shear axis {axis} {tuple(shape)} kmax {kmax} offset {offset}: "
                             f"kernel differs from plain")
    return int(direct.item())


def phase_shears(torch, shear):
    """Kernels 5 and 4, the rotation kernel's uint16 modes, at the padded
    canvas of the 288² store (32, 3, 412, 412) with the path's shift bounds,
    full-range values and slopes up to ±tan(22.5°) / ±sin(45°): each shear
    axis and the three-shear rotation against their plain versions (every
    tile of the rotation staged); then the rotation's cases: the path's
    extreme slopes, slopes beyond them (tiles on the direct walk), non-square
    canvases (one of them with rows not a multiple of 4 pixels), 1 and 5
    channels (5 walk every tile directly); the shear's cases on both axes
    (those of the rotation, one image, a shift bound past the canvas,
    canvases 1 and 3 elements into their buffers, a tall canvas whose ShY
    windows pass their cap and take the direct walk); then ``rotate3 ==
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
        rows[f"shear_axis{axis}"]["over_bound"] = rows[f"shear_axis{axis}"]["ms"] / bound_ms
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

    # the one-shear cases, each axis: (shape, ShX slopes, ShY slopes, kmax_x,
    # kmax_y, element offset of the canvas in its buffer)
    tall = ((2, 1, 1100, 40), cycle(2, [300.0, -300.0]), cycle(2, [300.0, -300.0]), 700, 700, 0)
    shear_cases = {
        "path extremes 412²": ((8, 3, n, n), *extreme, kmax_a, kmax_b, 0),
        "beyond the caps 412²": ((8, 3, n, n), *beyond, kmax_a, kmax_b, 0),
        "non-square 300 x 412": ((8, 3, 300, n), *extreme, kmax_a, kmax_b, 0),
        "non-square 257 x 301": ((8, 3, 257, 301), *extreme, kmax_a, kmax_b, 0),
        "beyond the caps 257 x 301": ((8, 3, 257, 301), *beyond, kmax_a, kmax_b, 0),
        "1 channel": ((8, 1, n, n), *extreme, kmax_a, kmax_b, 0),
        "5 channels": ((8, 5, 160, 200), *extreme, kmax_a, kmax_b, 0),
        "B = 1": ((1, 3, n, n), extreme[0][1:2], extreme[1][2:3], kmax_a, kmax_b, 0),
        "kmax > canvas": ((4, 3, 100, 90), cycle(4, [5.0, -7.5]), cycle(4, [-6.0, 9.0]), 300,
                          300, 0),
        "canvas 1 element into its buffer": ((8, 3, 257, 301), *extreme, kmax_a, kmax_b, 1),
        "canvas 3 elements into its buffer": ((8, 3, 300, n), *beyond, kmax_a, kmax_b, 3),
        "tall canvas, ShY window past its cap": tall,
    }
    shear_direct = {}
    for i, (name, (case_shape, sx, sy, kx, ky, offset)) in enumerate(shear_cases.items()):
        shear_case(torch, shear, case_shape, sx.float(), kx, 2, 80 + i, offset)
        shear_direct[name] = shear_case(torch, shear, case_shape, sy.float(), ky, 1, 90 + i,
                                        offset)
    if any(count for name, count in shear_direct.items() if name != "tall canvas, ShY window "
           "past its cap") or not shear_direct["tall canvas, ShY window past its cap"]:
        raise AssertionError(f"shear: ShY tiles on the direct walk {shear_direct}, expected "
                             f"them on the tall canvas alone")

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
        "shear_cases_equal_both_axes": list(shear_cases), "shear_y_direct_tiles": shear_direct,
        "shear_y_plan_412": shear.shear_y_plan(n, n, kmax_b),
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


def general_kernel(torch, pseudo_label, peaks, target, kw):
    """A call that writes GF alone through the general kernel of
    ``csrc/pseudo_label.cu`` at a map the 8-block kernel takes (the path's
    builds), beside the kernel ``launch_geometry`` picks there: the measure
    that keeps the two apart. Calls the library directly, so the wrapper's
    launch count does not see it."""
    size, joints = kw["out_size"], peaks.shape[1]
    geo = dict(pseudo_label.launch_geometry(size, joints), wide=True)
    assert geo["groups"] == 1 and geo["shared_bytes"] <= pseudo_label.SHARED_LIMIT, geo
    gf = torch.empty((peaks.shape[0], size, size, joints), device="cuda")
    fn, stream = pseudo_label._lib().pseudo_labels_f32, torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(peaks.data_ptr(), None if target is None else target.data_ptr(), None,
                 gf.data_ptr(), peaks.shape[0], size, joints, pseudo_label._two_sigma_sq(SIGMA),
                 kw["reach"], pseudo_label.GF_KINDS[kw["gf_kind"]], int(kw["normalize"]), 1,
                 geo["groups"], geo["threads"], geo["tile"], int(geo["staged"]),
                 geo["shared_bytes"], stream)
        if err != 0:
            raise RuntimeError(f"general label kernel launch failed: cudaError {err} ({geo})")
        return gf
    return launch


def label_row(torch, pseudo_label, batch, size, reach, gf_kind, fused, normalize, seed,
              plain_iters=100, general=False):
    """One label build checked by :func:`label_case` and timed with GT and
    GF alone, beside the plain version and the bounds; with ``general``,
    GF alone also checked and timed on the general kernel."""
    peaks, target, kw, gt, gf, err, atol = label_case(
        torch, pseudo_label, batch, size, JOINTS, reach, gf_kind, fused, normalize, seed)
    full = lambda: pseudo_label.pseudo_labels_cuda(peaks, target, **kw)  # noqa: E731
    gf_only = lambda: pseudo_label.pseudo_labels_cuda(  # noqa: E731
        peaks, target, with_gt=False, **kw)
    plain = lambda: pseudo_label.pseudo_labels_plain(peaks, target, **kw)  # noqa: E731
    bound_ms, bound_by = labels_bound_ms(batch, size, gf_kind, fused, normalize, gt)
    gf_bound_ms, _ = labels_bound_ms(batch, size, gf_kind, fused, normalize, gt, with_gt=False)
    row = {"shape": [batch, size, size, JOINTS], "gf_kind": gf_kind, "fused": fused,
           "normalize": normalize, "geometry": pseudo_label.launch_geometry(size, JOINTS),
           "max_abs_err": err, "atol": atol,
           "ms": cuda_ms(torch, full), "gf_only_ms": cuda_ms(torch, gf_only),
           "plain_ms": cuda_ms(torch, plain, iters=plain_iters, warmup=min(10, plain_iters)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gf_only_bound_ms": gf_bound_ms, "library_ms": None, "call_ms": host_ms(torch, full)}
    row.update(over_bound=row["ms"] / bound_ms, gf_only_over_bound=row["gf_only_ms"] / gf_bound_ms)
    if general:
        launch = general_kernel(torch, pseudo_label, peaks, target, kw)
        general_err = float((launch() - gf).abs().max())
        torch.cuda.synchronize()
        if not general_err <= atol:
            raise AssertionError(f"labels {size}²: the general kernel's GF differs by "
                                 f"{general_err} > {atol}")
        row["general_kernel"] = {"max_abs_err_to_kernel": general_err,
                                 "gf_only_ms": cuda_ms(torch, launch)}
    return row


def phase_labels(torch, pseudo_label):
    """Kernel 2: the three label builds of Step B (B = 32, K = 21), each with
    GT and GF alone, timed, and GF alone also on the general kernel; those
    of a run at ``--heatmap-size 96`` (96², 48², 24², and ``rd_plain``'s
    unnormalised union_others at 96²) and the larger maps 128² and 256²,
    timed; every GF kind with and without a fused
    target and normalisation at a small shape; the largest shapes of the
    8-block kernel, staged (K = 55 at 90²) and on the second pass (K = 64 at
    90²); the general kernel's joint groups (K = 65, 128, 600), each GF
    kind, and a map whose sum table takes tiles (400²)."""
    launches_before, rows = pseudo_label.launches, []
    for size, reach, gf_kind, fused, normalize in LABEL_SHAPES:
        rows.append(label_row(torch, pseudo_label, BATCH, size, reach, gf_kind, fused, normalize,
                              size, general=True))
    at_96 = [label_row(torch, pseudo_label, BATCH, size, reach, gf_kind, fused, normalize, seed,
                       plain_iters=20)
             for seed, (size, reach, gf_kind, fused, normalize) in enumerate(
                 [(96, 6, "union_minus", True, True), (48, 4, "inverse", True, True),
                  (24, 3, "inverse", False, False), (96, 6, "union_others", False, False),
                  (128, 6, "union_minus", True, True), (256, 6, "union_minus", True, True)],
                 start=100)]

    kinds = []
    for i, gf_kind in enumerate(pseudo_label.GF_KINDS):
        for fused in (False, True):
            for normalize in (False, True):
                *_, err, atol = label_case(torch, pseudo_label, 4, 24, JOINTS, 4, gf_kind, fused,
                                           normalize, 70 + 4 * i + 2 * fused + normalize, low=-3)
                kinds.append({"gf_kind": gf_kind, "fused": fused, "normalize": normalize,
                              "max_abs_err": err, "atol": atol})
    largest = []  # the 8-block kernel's largest shapes, then the general kernel's
    for batch, size, joints, gf_kind, fused, normalize in (
            (4, 90, 55, "union_minus", True, True), (4, 90, 64, "union_minus", True, True),
            (4, 24, 65, "union_minus", True, True), (4, 24, 128, "union_minus", True, True),
            (2, 24, 600, "union_minus", True, True), (2, 40, 600, "union_others", False, True),
            (2, 96, 65, "union_minus", True, True), (1, 400, 5, "union_minus", True, True),
            (2, 96, 21, "inverse", True, True), (2, 128, 21, "inverse", False, False),
            (2, 24, 65, "inverse", False, True)):
        *_, err, atol = label_case(torch, pseudo_label, batch, size, joints, 6, gf_kind, fused,
                                   normalize, size + joints, low=-3)
        largest.append({"shape": [batch, size, size, joints], "gf_kind": gf_kind,
                        "fused": fused, "normalize": normalize,
                        "geometry": pseudo_label.launch_geometry(size, joints),
                        "max_abs_err": err, "atol": atol})
    line("phase 2 pseudo-label kernel vs plain (GT torch.equal, GF atol)", {
        "shapes": rows, "heatmap_96_and_larger": at_96, "kinds_24x24": kinds,
        "largest_and_groups": largest, "launches": pseudo_label.launches - launches_before})
    # the path writes GF alone; its 64² build is the largest of an iteration,
    # and the error is the worst of every case
    worst = max([r["max_abs_err"] for r in rows + at_96 + kinds + largest])
    top = rows[0]
    return dict(top, ms=top["gf_only_ms"], bound_ms=top["gf_only_bound_ms"], max_abs_err=worst)


def build_model(torch, models, seed: int = 7, dtype=None):
    """Full-width ResNet-101 multi-head model with fan-in-scaled random
    weights and random BN stats (as ``tests/test_full_model_parity.py``),
    computing in ``dtype`` (None: float32)."""
    model = models.MultiHeadPoseResNet(models.resnet101(dtype=dtype), num_keypoints=JOINTS,
                                       dtype=dtype)
    return seed_weights(torch, model, seed)


def seed_weights(torch, model, seed: int):
    """``model`` with build_model's seeded weights and BN stats, in eval mode."""
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


def kernel_vs_plain(torch, train, model, state, stores, s_gen, t_gen, *, rtol, atol,
                    loss_rtol) -> dict:
    """One DA iteration from the same snapshot and draws through the kernels
    and again through their plain versions, cuDNN deterministic: the batches
    must be equal, the losses within ``loss_rtol`` and every weight within
    ``rtol`` / ``atol``."""
    from dahpe_tpu_torch.ops import gaussian, pseudo_label, shear

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
        if not torch.allclose(v, pw[k], rtol=rtol, atol=atol):
            raise AssertionError(f"training: {k} differs between kernel and plain runs")
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"training: losses differ by {loss_rel} between kernel and plain")

    return {"batches_equal": True, "loss_max_rel": loss_rel, "weights_max_abs": worst_abs,
            "weights_max_rel": worst_rel, "rtol": rtol, "atol": atol, "loss_rtol": loss_rtol}


def phase_training(torch, models, train, data, kernels, smi):
    """The full-width DA iteration (and one pretrain step) on the card."""
    import warnings

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
        state, metrics = fused(state, s_gen, t_gen)[:2]
    torch.cuda.synchronize()
    iters = 5
    kernels.reset()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = fused(state, s_gen, t_gen)[:2]
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
            state, metrics = fused(state, s_gen, t_gen)[:2]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0][:120] for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    profile = device_profile(torch, lambda: fused(state, s_gen, t_gen))
    launches_all = kernels.read()

    agreement = kernel_vs_plain(torch, train, model, state, stores, s_gen, t_gen,
                                rtol=1e-4, atol=1e-7, loss_rtol=1e-4)

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
        "kernel_vs_plain": agreement,
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


IMAGE_96, HEATMAP_96 = 384, 96  # --image-size 384 --heatmap-size 96 (cli/args.py:29-30)


def phase_training_96(torch, models, train, data, kernels, smi):
    """One DA iteration at ``--image-size 384 --heatmap-size 96`` (ResNet-101,
    batch 32 per domain, 288² stores), after one warm-up: the label kernel
    builds ``rd_64``'s 96² GF (the earlier design refused maps above 90²),
    three label launches an iteration, finite losses."""
    from dahpe_tpu_torch.ops import pseudo_label

    t0 = time.perf_counter()
    stores = [data.DeviceDataStore(SyntheticSplit(64, RAW, seed=seed), device="cuda",
                                   raw_size=RAW, verbose=False) for seed in (4, 5)]
    model = build_model(torch, models, seed=10).cuda()
    state = train.create_da_state(model, device="cuda", with_ema=True)
    fused = train.make_fused_da_iteration(model, stores[0], stores[1], BATCH,
                                          image_size=IMAGE_96, heatmap_size=HEATMAP_96,
                                          share_target_features=True, ema_decay=0.99)
    s_gen, t_gen = stores[0].generator(21), stores[1].generator(22)
    torch.cuda.reset_peak_memory_stats()
    state, metrics = fused(state, s_gen, t_gen)[:2]  # warm-up: cuDNN's algorithms
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels.reset()
    t0 = time.perf_counter()
    state, metrics = fused(state, s_gen, t_gen)[:2]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.read()
    expected = dict(NO_LAUNCHES, render_gaussian=7, pseudo_labels=3, rotate3_fused=2)
    if launches != expected:
        raise AssertionError(f"training at heatmap 96: launches {launches}, expected {expected}")
    losses = {k: float(metrics[k]) for k in ("loss_s", "loss_gf", "loss_gt")}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"training at heatmap 96: non-finite losses {losses}")
    line(f"phase 5c DA training resnet101 {IMAGE_96}²/{HEATMAP_96}²/21, batch 32+32", {
        "card": smi, "setup_and_warmup_s": setup_s, "ms_one_iteration": ms, "losses": losses,
        "launches": launches, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "label_geometry_96": pseudo_label.launch_geometry(HEATMAP_96, JOINTS)})
    return launches


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
            state = fused(state, s_gen, t_gen)[0]
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


def register_cut_domains():
    """The synthetic domains of the CLI phases, their depth cut (fewer
    frames per split), not their width."""
    from dahpe_tpu_torch import data
    from dahpe_tpu_torch.data import synthetic

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


def phase_cli(torch, kernels, smi, bare_ms, checkpoint):
    """The training CLI end to end on the card (see the module docstring)."""
    from dahpe_tpu_torch.cli import test as test_cli
    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    register_cut_domains()
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
    # the runs' checkpoints take several GB of disk; the logs, metrics and
    # the trace stay under build/chip_smoke_cli, the straight run's best
    # checkpoint for phase 7's artifact, and the pretrain checkpoint and the
    # decoded cache for phase 8's chunked runs (which delete them)
    kept_best = os.path.join(root, "phase7_best")
    shutil.move(os.path.join(straight, "best"), kept_best)
    kept_warm = os.path.join(root, "phase8_pretrain")
    shutil.move(warm, kept_warm)
    for name in os.listdir(root):
        shutil.rmtree(os.path.join(root, name, "checkpoints"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "phase6_state"), ignore_errors=True)
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
    return launches, {"best": kept_best, "scores": scores, "argv": argv, "pretrain": kept_warm,
                      "root": root, "val_batches": val_batches}


def _timed_requests(client, frames_by_n):
    """Sequential requests through ``client``: one warm-up (the bucket's
    graph capture) then the timed ones; ms per request (mean, p50), img/s."""
    out = {}
    for n, (frames, reps) in frames_by_n.items():
        client.predict(frames)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            coords, maxvals = client.predict(frames)
            times.append((time.perf_counter() - t0) * 1e3)
        if coords.shape != (n, JOINTS, 2) or not np.isfinite(coords).all():
            raise AssertionError(f"serving artifact: {n} frames gave {coords.shape}")
        ms = float(np.mean(times))
        out[n] = {"ms_per_request": ms, "p50_ms": float(np.median(times)),
                  "img_per_s": n * 1e3 / ms, "requests": reps}
    return out


def _concurrent_singles(port, frames, n=16):
    """``n`` single-frame requests at once, each from its own client: the
    server's request and batch counts over the burst."""
    import threading

    from dahpe_tpu_torch.client import PoseClient

    with PoseClient("127.0.0.1", port, timeout=120) as c:
        before = c.health()
    errors, barrier = [], threading.Barrier(n)

    def one(i):
        try:
            with PoseClient("127.0.0.1", port, timeout=120) as c:
                barrier.wait(timeout=60)
                coords, _ = c.predict(frames[i:i + 1])
                if coords.shape != (1, JOINTS, 2):
                    raise AssertionError(coords.shape)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    with PoseClient("127.0.0.1", port, timeout=120) as c:
        after = c.health()
    requests = after["requests"] - before["requests"]
    batches = after["batches"] - before["batches"]
    return {"requests": requests, "batches": batches, "coalescing_ratio": requests / batches,
            "burst_s": seconds, "graphs": after["graphs"]}


def phase_artifacts(torch, models, kernels, smi, phase3, cli_best):
    """Phase 7: the serving deployment path on the card (module docstring)."""
    import threading

    from dahpe_tpu_torch import evaluate, quant, serving
    from dahpe_tpu_torch.cli import export as export_cli
    from dahpe_tpu_torch.cli import serve
    from dahpe_tpu_torch.cli import test as test_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.client import PoseClient
    from dahpe_tpu_torch.data.device_aug import IMAGENET_MEAN, IMAGENET_STD

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_serving")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.reset_peak_memory_stats()
    device = CLI_DEVICE
    model = build_model(torch, models).to(device)  # phase 3's weights (same seed)
    rng = np.random.default_rng(70)
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def normalized(frames):
        return (torch.from_numpy(frames).to(device).float() / 255.0 - mean) / std

    # export: float (uint8 ingest, batch-polymorphic) and int8 (calibrated on
    # seeded frames, bfloat16 glue), each beside its npz weights
    paths = {"float": os.path.join(root, "float.pt2"), "int8": os.path.join(root, "int8.pt2")}
    seconds, sizes = {}, {}
    t0 = time.perf_counter()
    serving.save_predict(paths["float"], model, image_size=IMAGE, heatmap_size=HEATMAP,
                         uint8_input=True, device=device)
    serving.save_variables_npz(paths["float"] + ".weights.npz", model)
    seconds["float_export"] = time.perf_counter() - t0
    calib = normalized(rng.integers(0, 256, (16, IMAGE, IMAGE, 3), dtype=np.uint8))
    t0 = time.perf_counter()
    qtree = quant.quantize_model(model, calib)
    torch.cuda.synchronize()
    seconds["int8_calibrate_quantize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(paths["int8"], "wb") as f:
        f.write(serving.export_predict_int8(qtree, image_size=IMAGE, heatmap_size=HEATMAP,
                                           uint8_input=True, glue="bfloat16", device=device))
    serving.save_quantized_npz(paths["int8"] + ".weights.npz", qtree)
    seconds["int8_export"] = time.perf_counter() - t0
    for kind, path in paths.items():
        sizes[kind] = {"artifact_bytes": os.path.getsize(path),
                       "npz_bytes": os.path.getsize(path + ".weights.npz")}
    del calib

    # _int_mm against its plain version at every conv of ResNet-101, on the
    # int8 activations one frame's forward gives each conv
    tree = quant.to_torch(qtree, device)
    frames8 = rng.integers(0, 256, (8, IMAGE, IMAGE, 3), dtype=np.uint8)
    x8 = normalized(frames8)
    calls, real_conv = [], quant.int8_conv

    def recording(xq, wq, **kw):
        calls.append((xq, wq, kw))
        return real_conv(xq, wq, **kw)

    quant.int8_conv = recording
    try:
        quant.apply_int8(tree, x8[:1])
    finally:
        quant.int8_conv = real_conv
    shapes = set()
    for xq, wq, kw in calls:
        got, want = real_conv(xq, wq, **kw), quant.int8_conv_plain(xq, wq, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"int8 conv {tuple(wq.shape)} {kw}: _int_mm differs from "
                                 "the float64 convolution")
        shapes.add((tuple(xq.shape), tuple(wq.shape), kw["stride"], str(kw["padding"])))
    del calls

    # int8 heatmaps against the float ones (tests/test_quant.py:106's bound)
    with torch.no_grad():
        y_f = model.main_head(model.features(x8))
    y_q = quant.apply_int8(tree, x8, glue=torch.bfloat16)
    int8_mae, float_std = float((y_q - y_f).abs().mean()), float(y_f.std())
    if not int8_mae < 0.1 * float_std:
        raise AssertionError(f"int8 heatmaps: mean abs error {int8_mae} >= 0.1 * {float_std}")

    # prominent joints of the float heatmaps: where a near-tie cannot flip
    flat = y_f.reshape(8, -1, JOINTS)
    top2 = flat.topk(2, dim=1).values
    prominent = ((top2[:, 0] - top2[:, 1]) > 1e-4).cpu()
    live_coords, live_maxvals = evaluate.make_predict_fn(
        model, image_size=IMAGE, heatmap_size=HEATMAP, uint8_input=True, device=device)(frames8)
    live_maxvals = live_maxvals.cpu().numpy()[..., 0]
    del model, tree, y_f, y_q, x8

    requests = {1: (rng.integers(0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8), 30),
                8: (frames8, 20),
                32: (rng.integers(0, 256, (32, IMAGE, IMAGE, 3), dtype=np.uint8), 10)}
    singles = rng.integers(0, 256, (16, IMAGE, IMAGE, 3), dtype=np.uint8)
    served = {}
    for kind, path in paths.items():
        t0 = time.perf_counter()
        server = serve.create_server(serve.build_serve_parser().parse_args(
            [path, "--host", "127.0.0.1", "--port", "0", "--batch-window", "2",
             "--device", device]))
        load_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            with PoseClient("127.0.0.1", port, timeout=120) as client:
                timing = _timed_requests(client, requests)
                coords_http, maxvals_http = client.predict(frames8)
            burst = _concurrent_singles(port, singles)
            if not burst["batches"] < burst["requests"]:
                raise AssertionError(f"{kind}: no coalescing under concurrent load {burst}")
            # graph replay against eager execution of the same artifact
            servable = server.servable
            for n, (frames, _) in requests.items():
                coords_g, maxvals_g = servable.run_arrays(frames)
                coords_e, maxvals_e = servable.predict(servable.weights,
                                                       torch.from_numpy(frames).to(device))
                if not (np.array_equal(coords_g, coords_e.cpu().numpy())
                        and np.array_equal(maxvals_g, maxvals_e.cpu().numpy()[..., 0])):
                    raise AssertionError(f"{kind}: graph replay at {n} frames differs from eager")
            # the layers under the HTTP request: one dispatch (pad, copy in,
            # replay, copy out), the same call run eagerly, and the replay's
            # device time alone
            breakdown = {}
            for n, (frames, reps) in requests.items():
                x = torch.from_numpy(frames).to(device)
                graph = (servable._graphs.get(n) or [None])[0]  # one card: one graph
                breakdown[n] = {
                    "dispatch_ms": host_ms(torch, lambda: servable.run_arrays(frames), reps),
                    "eager_ms": host_ms(torch, lambda: [t.cpu() for t in servable.predict(
                        servable.weights, x)], reps),
                    "replay_device_ms": (cuda_ms(torch, graph.graph.replay, iters=reps, warmup=2)
                                         if graph is not None else "not measured"),
                }
            graphs = servable.info()["graphs"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        if kind == "float" and not torch.equal(torch.from_numpy(coords_http)[prominent],
                                               live_coords.cpu()[prominent]):
            raise AssertionError("float artifact: coordinates differ from phase 3's predict")
        served[kind] = {"requests": timing, "layers": breakdown, "concurrent_16_singles": burst,
                        "graphs_captured": graphs, "server_start_s": load_s, **sizes[kind]}
        if kind == "float":
            served[kind]["maxvals_vs_phase3_max_abs"] = float(
                np.abs(maxvals_http - live_maxvals).max())
        del server
        torch.cuda.empty_cache()

    # cli.export of phase 6's best checkpoint (float32 input), then cli.test
    # --artifact on the same splits: the checkpoint's PCK exactly
    artifact = os.path.join(root, "best.pt2")
    t0 = time.perf_counter()
    export_cli.main(export_cli.build_export_parser().parse_args(
        [cli_best["best"], "-o", artifact, "-a", CLI_ARCH, "--device", device,
         "--image-size", str(IMAGE), "--heatmap-size", str(HEATMAP)]))
    seconds["cli_export_best"] = time.perf_counter() - t0
    kernels.reset()  # main path 4: the artifact's evaluation on the card
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as phase 6 scored the checkpoint
    try:
        scores = test_cli.main(build_parser("test").parse_args(
            cli_best["argv"]("test_artifact", "--artifact", artifact)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    launches = kernels.read()
    if scores != cli_best["scores"]:
        raise AssertionError(f"cli.test --artifact: PCK {scores} != --checkpoint "
                             f"{cli_best['scores']}")
    shutil.rmtree(cli_best["best"], ignore_errors=True)
    for name in os.listdir(root):  # the artifacts and weights: ~1 GB
        if not name.startswith("float.pt2"):  # phase 10d serves the float one
            os.remove(os.path.join(root, name))
    line("phase 7 serving artifacts resnet101 256²/64²/21", {
        "card": smi, "seconds": seconds, "int8_conv_shapes_checked": len(shapes),
        "int8_vs_float": {"mean_abs_err": int8_mae, "float_std": float_std, "bound": 0.1},
        "prominent_joints": int(prominent.sum()), "served": served,
        "in_process_phase3": phase3, "batch_window_ms": 2,
        "cli_test_artifact": {"target": scores["target"]["all"], "source": scores["source"],
                              "equals_checkpoint": True},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    return launches


GRAPH_K = 4  # --steps-per-call of phase 8
ADAPT_ITERS = 200  # phase 8c: the acceptance run's 4000 + 3000 iterations cut to 200 + 200
# the adaptation acceptance configuration (phases 8c, 9e, 12), iterations set per run
ACCEPTANCE = dict(arch="resnet18", batch=32, n_train=512, n_val=128, image_size=128,
                  heatmap_size=32, raw_size=160, shift=0.3, content=0.3, style=1.0,
                  ema_decay=0.99, conf_gate=0.5, eval_every=100, seed=0, verbose=False)


def live_tensors(state) -> list:
    """Every tensor an iteration writes in place, in a fixed order: weights,
    BN statistics and counters, momentum buffers and EMA entries."""
    out = list(state.model.state_dict().values())
    for opt in state.optimizers.values():
        out += [opt.state[p]["momentum_buffer"] for g in opt.param_groups for p in g["params"]]
    return out + (list(state.ema.values()) if getattr(state, "ema", None) else [])


def take(state, gens):
    """What an iteration changes, to be put back in place (a captured graph
    goes on writing the tensors it recorded): tensors, step, generators."""
    return ([t.detach().clone() for t in live_tensors(state)], state.step,
            [g.get_state() for g in gens])


def put(torch, state, gens, snap):
    tensors, step, gen_states = snap
    with torch.no_grad():
        for t, v in zip(live_tensors(state), tensors):
            t.copy_(v)
    state.step = step
    for g, st in zip(gens, gen_states):
        g.set_state(st)


def graph_kernel_nodes(torch, call, names) -> dict:
    """Run ``call``, which captures one CUDA graph, with the graph kept
    after capture (``keep_graph``: instantiated at its first replay); the
    kernel nodes of each of ``names`` in the captured graph, read from its
    DOT dump (``cudaGraphDebugDotPrint``: one line a node)."""
    made, real = [], torch.cuda.CUDAGraph

    def recorded(*args, **kwargs):
        graph = real(*args, **dict(kwargs, keep_graph=True))
        made.append(graph)
        return graph

    torch.cuda.CUDAGraph = recorded
    try:
        call()
    finally:
        torch.cuda.CUDAGraph = real
    torch.cuda.synchronize()
    if len(made) != 1:
        raise AssertionError(f"expected one captured graph, {len(made)} were made")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "graph.dot")
    made[0].debug_dump(path)
    with open(path) as fh:
        nodes = [ln for ln in fh if "->" not in ln]
    os.remove(path)
    counts = {k: sum(k in ln for ln in nodes) for k in names}
    if not any(counts.values()):
        sample = [ln[:300] for ln in nodes if "KERNEL" in ln.upper()][:3]
        raise AssertionError(f"no path kernel node found in the graph's dump; nodes like {sample}")
    return counts


def state_agreement(torch, got, want, rtol=5e-3, atol=5e-5) -> dict:
    """Tensors of two snapshots: how many differ at all, the worst share of
    the DA parity tolerance (``tests/test_da_parity.py:221-223``) any entry
    uses (< 1 passes) and the worst absolute difference."""
    unequal, share, worst = 0, 0.0, 0.0
    for a, b in zip(got, want):
        if torch.equal(a, b):
            continue
        unequal += 1
        if a.is_floating_point():
            d = (a.double() - b.double()).abs()
            worst = max(worst, float(d.max()))
            share = max(share, float((d / (atol + rtol * b.double().abs())).max()))
        else:
            share = float("inf")
    return {"tensors": len(want), "unequal": unequal, "bit_equal": unequal == 0,
            "worst_share_of_tolerance": share, "max_abs_diff": worst, "rtol": rtol, "atol": atol}


def timed_calls(torch, call, calls: int, per_call: int, images: int) -> dict:
    """ms per iteration over ``calls`` warm calls of ``per_call`` iterations,
    by CUDA events and by the host clock (ending in a synchronize)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        call()
    end.record()
    end.synchronize()
    iters = calls * per_call
    host = (time.perf_counter() - t0) * 1e3 / iters
    return {"iterations": iters, "cuda_event_ms_per_iter": start.elapsed_time(end) / iters,
            "host_ms_per_iter": host, "img_per_s": images * 1e3 / host}


def graph_check(torch, make_call, state, gens, images: int) -> dict:
    """Phase 8a for one kind of iteration. ``make_call(k)`` wraps a fresh
    ``steps_per_call=k`` iteration into a no-argument call on ``state`` and
    ``gens``. With cuDNN deterministic, from one snapshot: ``GRAPH_K`` eager
    single calls twice (the noise floor) and the graphed chunk (its first
    call, the eager warm-up, put back first). Then, at cuDNN's defaults, as
    phase 5 runs: kernels per replay by name, times at K = 1, ``GRAPH_K``
    and 8, idle shares and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        single = make_call(1)
        for _ in range(2):  # cuDNN's algorithms; momentum buffers exist after
            single()
        snap = take(state, gens)
        eager = []
        for _ in range(2):
            put(torch, state, gens, snap)
            for _ in range(GRAPH_K):
                single()
            eager.append(take(state, gens))
        chunked = make_call(GRAPH_K)
        put(torch, state, gens, snap)
        chunked()  # the first call: GRAPH_K eager iterations
        put(torch, state, gens, snap)
        t0 = time.perf_counter()
        chunked()  # the capture, then GRAPH_K replays
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        graphed = take(state, gens)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if graphed[1] != eager[0][1] or not all(torch.equal(a, b)
                                            for a, b in zip(graphed[2], eager[0][2])):
        raise AssertionError("graphs: the replayed chunk's step or generators differ from "
                             f"{GRAPH_K} eager calls'")
    floor = state_agreement(torch, eager[1][0], eager[0][0])
    agreement = state_agreement(torch, graphed[0], eager[0][0])
    if not agreement["worst_share_of_tolerance"] < 1.0:
        raise AssertionError(f"graphs: replayed state outside the DA parity tolerance: "
                             f"{agreement}; eager against eager: {floor}")
    single, chunked = make_call(1), make_call(GRAPH_K)
    single()
    chunked()  # warm-up
    chunked()  # capture and replays
    eager_profile = device_profile(torch, single)
    replay_profile = device_profile(torch, chunked)
    per_eager = {k: eager_profile["port_kernel_launches"][k] for k in PATH_KERNEL_NAMES}
    per_replay = {k: replay_profile["port_kernel_launches"][k] / GRAPH_K for k in PATH_KERNEL_NAMES}
    if per_replay != per_eager or not any(per_eager.values()):
        raise AssertionError(f"graphs: kernels per replay {per_replay}, per eager iteration "
                             f"{per_eager}")
    times = {"k1_eager": timed_calls(torch, single, 4, 1, images),
             f"k{GRAPH_K}_replayed": timed_calls(torch, chunked, 2, GRAPH_K, images)}
    chunk8 = make_call(8)
    chunk8()  # warm-up
    chunk8()  # capture and replays
    times["k8_replayed"] = timed_calls(torch, chunk8, 2, 8, images)
    return {"replay_vs_eager": {"generators_equal": True, "steps_equal": True, **agreement},
            "eager_vs_eager": floor, "cudnn_deterministic_for_the_check": True,
            "capture_and_replay_s": capture_s, "kernels_per_eager_iteration": per_eager,
            "kernels_per_replay": per_replay, "times": times,
            "idle_share": {"k1_eager": eager_profile["idle_share"],
                           f"k{GRAPH_K}_replayed": replay_profile["idle_share"]},
            "device_busy_ms_per_iter": {
                "k1_eager": eager_profile["device_busy_ms"],
                f"k{GRAPH_K}_replayed": replay_profile["device_busy_ms"] / GRAPH_K},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_graphs(torch, models, train, data, smi):
    """Phase 8a: the DA iteration at phase 5's configuration and the pretrain
    iteration, each replayed from a CUDA graph against eager execution."""
    t0 = time.perf_counter()
    stores = [data.DeviceDataStore(SyntheticSplit(256, RAW, seed=seed), device="cuda",
                                   raw_size=RAW, verbose=False) for seed in (2, 3)]
    model = build_model(torch, models, seed=9).cuda()
    state = train.create_da_state(model, device="cuda", with_ema=True)
    gens = [stores[0].generator(11), stores[1].generator(12)]

    def da_call(k):
        fused = train.make_fused_da_iteration(model, stores[0], stores[1], BATCH,
                                              steps_per_call=k, share_target_features=True,
                                              ema_decay=0.99)
        return lambda: fused(state, *gens)[1]

    da = graph_check(torch, da_call, state, gens, 2 * BATCH)
    del model, state, da_call
    torch.cuda.empty_cache()
    pose = models.PoseResNet(models.resnet101(), num_keypoints=JOINTS).cuda()
    pstate = train.create_pretrain_state(pose, device="cuda")
    p_gens = [stores[0].generator(13)]

    def pre_call(k):
        fused = train.make_fused_pretrain_iteration(pose, stores[0], BATCH, steps_per_call=k)
        return lambda: fused(pstate, p_gens[0], 0.001)[1]

    pre = graph_check(torch, pre_call, pstate, p_gens, BATCH)
    line(f"phase 8a graphed iterations resnet101 256²/64²/21, K={GRAPH_K} replays vs eager", {
        "card": smi, "seconds": time.perf_counter() - t0, "da_batch_32_plus_32": da,
        "pretrain_batch_32": pre})
    return da["times"]


def phase_cli_chunked(torch, kernels, smi, cli, bf16: bool = False):
    """Phase 8b: the training CLI at phase 6's configuration with
    ``--steps-per-call 4``: ``--max-steps 4`` then ``--resume`` to 8 against
    a straight run to 8 (whose second chunk is a replay), cuDNN
    deterministic; the launches the runs imply. With ``bf16`` (phase 9d)
    the runs take ``--bf16``, the resume must be bit for bit, and
    ``cli.test --bf16`` on the straight run's ``best`` must score the PCK
    the run logged (8 iterations leave it at 0, so this holds the CLI path,
    not bfloat16 evaluation, which phase 9e holds); then phase 6's pretrain
    checkpoint and decoded cache are deleted."""
    from dahpe_tpu_torch.cli import test as test_cli
    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    argv, root = cli["argv"], cli["root"]
    tag = "bf16_" if bf16 else ""
    common = ("--pretrain", cli["pretrain"], "--epochs", "2", "-i", str(GRAPH_K),
              "--steps-per-call", str(GRAPH_K), *(("--bf16",) if bf16 else ()))
    seconds = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("cut", ("--max-steps", str(GRAPH_K))),
                            ("resumed", ("--max-steps", str(2 * GRAPH_K), "--resume",
                                         os.path.join(root, tag + "chunk_cut", "checkpoints",
                                                      "latest"))),
                            ("straight", ("--max-steps", str(2 * GRAPH_K)))):
            t0 = time.perf_counter()
            log = tag + ("chunk_straight" if name == "straight" else "chunk_cut")
            train_cli.main(build_parser("train").parse_args(argv(log, *common, *extra)))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
        if bf16:
            t0 = time.perf_counter()
            scores = test_cli.main(build_parser("test").parse_args(argv(
                tag + "test", "--bf16", "--checkpoint",
                os.path.join(root, tag + "chunk_straight", "checkpoints", "best"))))
            seconds["cli_test_best"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = kernels.read()
    latest = [os.path.join(root, tag + log, "checkpoints", "latest")
              for log in ("chunk_cut", "chunk_straight")]
    resumed, direct = (fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(p)) for p in latest)
    if ([p for p, _ in resumed] != [p for p, _ in direct]
            or int(dict(resumed)[("step",)]) != 2 * GRAPH_K):
        raise AssertionError("chunked resume: the checkpoints hold different trees or steps")
    unequal, worst = 0, 0.0
    for (path, x), (_, y) in zip(resumed, direct):
        if not torch.equal(x, y):
            unequal += 1
            if x.is_floating_point():
                worst = max(worst, float((x - y).abs().max()))
            if bf16 or not torch.allclose(x.double(), y.double(), rtol=1e-4, atol=1e-6):
                raise AssertionError(f"chunked resume: {'/'.join(path)} differs from the "
                                     "straight run")
    floats = [x for _, x in resumed if x.is_floating_point()]
    if not all(x.dtype == torch.float32 and bool(torch.isfinite(x).all()) for x in floats):
        raise AssertionError("chunked resume: a saved tensor is not finite float32")
    aux = [ckpt.load_aux(p) for p in latest]
    if not all(np.array_equal(aux[0][k], aux[1][k]) for k in ("key_s", "key_t")):
        raise AssertionError("chunked resume: the sampling generators did not continue")
    # wrapper launches: every eager iteration (the cut and resumed runs' one
    # chunk each, the straight run's first) and the one capture, 7/3/2 each;
    # one Gaussian per eval batch of the straight run's epoch-0 validation
    # (source, target, EMA), and with bf16 cli.test's (source, target)
    iterations = 3 * GRAPH_K + 1
    eval_batches = (3 + (2 if bf16 else 0)) * cli["val_batches"]
    expected = dict(NO_LAUNCHES, render_gaussian=7 * iterations + eval_batches,
                    pseudo_labels=3 * iterations, rotate3_fused=2 * iterations)
    if launches != expected:
        raise AssertionError(f"chunked cli: launches {launches}, expected {expected}")
    records = [json.loads(r) for r in open(os.path.join(root, tag + "chunk_straight",
                                                        "metrics.jsonl"))]
    extra = {}
    if bf16:
        best = max(r["best_target"] for r in records)
        if abs(scores["target"]["all"] - best) > 1e-6:
            raise AssertionError(f"cli.test --bf16 on best: PCK {scores['target']['all']} "
                                 f"!= logged {best}")
        extra["cli_test_best"] = {"target": scores["target"]["all"], "logged": best}
    for name in os.listdir(root):
        shutil.rmtree(os.path.join(root, name, "checkpoints"), ignore_errors=True)
    if bf16:  # the last run on phase 6's warm start and cache
        for name in ("cache", "phase8_pretrain"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    title = (f"phase 9d training CLI --bf16 --steps-per-call {GRAPH_K}" if bf16
             else f"phase 8b training CLI --steps-per-call {GRAPH_K}")
    line(f"{title} resnet101 256²/64², batch 32", {
        "card": smi, "run_s": seconds, **extra, "straight_epoch0": {
            k: records[0][k] for k in ("loss_s", "loss_gf", "loss_gt", "val_target_ema")},
        "resume": {"steps": [GRAPH_K, 2 * GRAPH_K], "leaves": len(resumed),
                   "unequal_leaves": unequal, "max_abs_diff": worst,
                   "bit_identical": unequal == 0, "generators_equal": True,
                   "rtol": 1e-4, "atol": 1e-6},
        "launches": launches})
    return launches


def bf16_eval_against_float32(torch, result: dict, calls: list) -> dict:
    """Phase 9e's check of bfloat16 evaluation where the PCK is far from 0:
    the trained bfloat16 DA model's target PCK (the result's ``da``) against
    a float32 twin of the same weights on the same split. ``calls`` are the
    experiment's evaluations in order (pretrain source and target, control,
    the DA curve, the EMA twin), each ``(model, args, kwargs, pck)``.
    Rounding the activations and weights to bfloat16 moves a joint's
    argmax only where its heatmap nearly ties, so the two PCKs stay within
    ``BF16_EVAL_PCK_TOL``; a decode that fails on bfloat16 maps (no peaks,
    wrong axes or scale) moves the PCK by most of its value."""
    from dahpe_tpu_torch import models
    from dahpe_tpu_torch.evaluate import make_eval_step
    from dahpe_tpu_torch.experiments import adaptation

    model, args, kw, pck16 = calls[-2]
    if pck16 != result["da"] or calls[-1][3] != result["da_ema"]:
        raise AssertionError("adaptation --bf16: the DA model's evaluation was not found")
    twin = models.MultiHeadPoseResNet(models.get_backbone("resnet18"),
                                      num_keypoints=JOINTS).cuda()
    twin.load_state_dict(model.state_dict())
    pck32 = adaptation._eval_target(twin, *args,
                                    **{**kw, "eval_step": make_eval_step(twin, device="cuda")})
    if not abs(pck16 - pck32) <= BF16_EVAL_PCK_TOL:
        raise AssertionError(f"adaptation --bf16: target PCK {pck16} in bfloat16, {pck32} "
                             f"in float32 on the same weights")
    return {"target_pck_bf16": pck16, "target_pck_float32_same_weights": pck32,
            "abs_diff": abs(pck16 - pck32), "tolerance": BF16_EVAL_PCK_TOL}


def phase_adaptation(torch, smi, bf16: bool = False):
    """Phase 8c: the adaptation experiment at its acceptance configuration
    (resnet18 at 128²/32², shift 0.3, content 0.3, style 1.0, EMA 0.99,
    confidence gate 0.5, seed 0), cut to ``ADAPT_ITERS`` + ``ADAPT_ITERS``
    iterations; every number it returns must be finite. With ``bf16``
    (phase 9e) it computes in bfloat16, and the trained DA model's
    evaluation is held against float32 (:func:`bf16_eval_against_float32`)."""
    from dahpe_tpu_torch.experiments import adaptation, run_adaptation_experiment

    t0 = time.perf_counter()
    calls, real_eval = [], adaptation._eval_target

    def recorded(model, *args, **kw):
        pck = real_eval(model, *args, **kw)
        calls.append((model, args, kw, pck))
        return pck

    adaptation._eval_target = recorded
    try:
        result = run_adaptation_experiment(pre_iters=ADAPT_ITERS, da_iters=ADAPT_ITERS,
                                           bf16=bf16, **ACCEPTANCE)
    finally:
        adaptation._eval_target = real_eval
    seconds = time.perf_counter() - t0
    numbers = [v for v in result.values() if isinstance(v, float)]
    numbers += [p for _, p in result["curve"]]
    if not all(np.isfinite(v) for v in numbers):
        raise AssertionError(f"adaptation: non-finite result {result}")
    extra = {"bf16_eval_vs_float32": bf16_eval_against_float32(torch, result, calls)} if bf16 \
        else {}
    title = "phase 9e adaptation --bf16" if bf16 else "phase 8c adaptation"
    line(f"{title} resnet18 128²/32², {ADAPT_ITERS}+{ADAPT_ITERS} iterations, seed 0",
         {"card": smi, "seconds": seconds, "cut": {"pre_iters": ADAPT_ITERS,
                                                   "da_iters": ADAPT_ITERS,
                                                   "acceptance": [4000, 3000]},
          "result": result, **extra})


def bf16_step_checks(torch, model, state, single, kernels, iters: int = 4) -> dict:
    """``iters`` eager bfloat16 DA iterations: 7 / 3 / 2 path-kernel launches
    each, every float32 parameter moved and finite, the BN statistics and
    EMA finite, the metrics finite; then the model's heatmaps are bfloat16."""
    before = [p.detach().clone() for p in model.parameters()]
    kernels.reset()
    for _ in range(iters):
        metrics = single()
    torch.cuda.synchronize()
    launches = kernels.read()
    expected = dict(NO_LAUNCHES, render_gaussian=7, pseudo_labels=3, rotate3_fused=2)
    if launches != {k: v * iters for k, v in expected.items()}:
        raise AssertionError(f"bf16 training: launches {launches} for {iters} iterations, "
                             f"expected {expected} each")
    params = list(model.parameters())
    if not all(p.dtype == torch.float32 for p in params):
        raise AssertionError("bf16 training: a parameter is not float32")
    moved = sum(int(not torch.equal(p, b)) for p, b in zip(params, before))
    if moved != len(params):
        raise AssertionError(f"bf16 training: {len(params) - moved} parameters did not move")
    tensors = params + list(model.buffers()) + list((state.ema or {}).values())
    if not all(bool(torch.isfinite(t).all()) for t in tensors if t.is_floating_point()):
        raise AssertionError("bf16 training: a parameter, statistic or EMA entry is not finite")
    losses = {k: float(metrics[k]) for k in ("loss_s", "loss_gf", "loss_gt")}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"bf16 training: non-finite losses {losses}")
    with torch.no_grad():
        model.eval()
        out = model(torch.zeros(2, IMAGE, IMAGE, 3, device=params[0].device))
        model.train()
    dtypes = {k: str(v.dtype).split(".")[-1] for k, v in out.items()}
    if set(dtypes.values()) != {"bfloat16"}:
        raise AssertionError(f"bf16 training: outputs {dtypes}")
    return {"launches_per_iter": {k: v // iters for k, v in launches.items() if v},
            "parameters_moved": f"{moved}/{len(params)}", "losses": losses,
            "output_dtypes": dtypes, "all_finite": True}


def phase_bf16_training(torch, models, train, data, kernels, smi):
    """Phase 9a/9b: the DA and pretrain iterations with bfloat16 compute at
    phase 5's configuration (module docstring)."""
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    stores = [data.DeviceDataStore(SyntheticSplit(256, RAW, seed=seed), device="cuda",
                                   raw_size=RAW, verbose=False) for seed in (2, 3)]
    model = build_model(torch, models, seed=9, dtype=bf16).cuda()
    state = train.create_da_state(model, device="cuda", with_ema=True)
    gens = [stores[0].generator(11), stores[1].generator(12)]

    def da_call(k):
        fused = train.make_fused_da_iteration(model, stores[0], stores[1], BATCH,
                                              steps_per_call=k, share_target_features=True,
                                              ema_decay=0.99)
        return lambda: fused(state, *gens)[1]

    single = da_call(1)
    for _ in range(2):  # warm-up: cuDNN picks its algorithms
        single()
    checks = bf16_step_checks(torch, model, state, single, kernels)
    agreement = kernel_vs_plain(torch, train, model, state, stores, *gens, rtol=1e-4,
                                atol=1e-7, loss_rtol=1e-4)
    profile = device_profile(torch, single, n_top=12)
    # what bf16 adds in front of the label kernel: the fused target's cast
    # to float32 (ops/pseudo_label.py), one elementwise pass per Step B build
    casts = {}
    for size in (HEATMAP, HEATMAP // 2):
        t = torch.randn(BATCH, size, size, JOINTS, device="cuda").to(torch.bfloat16)
        casts[f"{size}²"] = {"ms": cuda_ms(torch, lambda t=t: t.to(torch.float32).contiguous()),
                             "bound_ms": t.numel() * 6 / HBM_BYTES_PER_S * 1e3}
    flops = flops_per_da_iteration(torch, models, BATCH)
    if "device_busy_ms" in profile:
        rate = flops / (profile["device_busy_ms"] / 1e3)
        profile.update(est_flop_per_iter=flops, est_flop_per_s_busy=rate,
                       est_share_of_bf16_dense_peak=rate / BF16_OPS_PER_S)
    graphs = graph_check(torch, da_call, state, gens, 2 * BATCH)
    if graphs["eager_vs_eager"]["bit_equal"] and not graphs["replay_vs_eager"]["bit_equal"]:
        raise AssertionError(f"bf16 graphs: two eager runs agree bit for bit, the replay not: "
                             f"{graphs['replay_vs_eager']}")
    line("phase 9a DA training --bf16 resnet101 256²/64²/21, batch 32+32, 288² stores", {
        "card": smi, "seconds": time.perf_counter() - t0, **checks,
        "kernel_vs_plain": agreement, "fused_target_cast": casts, "profile_k1_eager": profile,
        "graphs": graphs})
    del model, state, single, da_call
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pose = models.PoseResNet(models.resnet101(dtype=bf16), num_keypoints=JOINTS,
                             dtype=bf16).cuda()
    pstate = train.create_pretrain_state(pose, device="cuda")
    p_gens = [stores[0].generator(13)]

    def pre_call(k):
        fused = train.make_fused_pretrain_iteration(pose, stores[0], BATCH, steps_per_call=k)
        return lambda: fused(pstate, p_gens[0], 0.001)[1]

    pre = graph_check(torch, pre_call, pstate, p_gens, BATCH)
    if pre["eager_vs_eager"]["bit_equal"] and not pre["replay_vs_eager"]["bit_equal"]:
        raise AssertionError(f"bf16 pretrain graphs: the replay differs from eager execution: "
                             f"{pre['replay_vs_eager']}")
    if not all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in pose.parameters()):
        raise AssertionError("bf16 pretrain: a parameter is not finite float32")
    line("phase 9b pretrain --bf16 resnet101, batch 32", {
        "card": smi, "seconds": time.perf_counter() - t0, "graphs": pre})


def phase_bf16_serving(torch, models, evaluate, smi):
    """Phase 9c: phase 3's model exported by ``cli.export --bf16
    --uint8-input`` and served in process and over HTTP (module
    docstring)."""
    import threading

    from dahpe_tpu_torch import serving
    from dahpe_tpu_torch.cli import export as export_cli
    from dahpe_tpu_torch.cli import serve
    from dahpe_tpu_torch.client import PoseClient
    from dahpe_tpu_torch.data.device_aug import IMAGENET_MEAN, IMAGENET_STD
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_bf16")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.reset_peak_memory_stats()
    model32 = build_model(torch, models).cuda()  # phase 3's weights (same seed)
    checkpoint, out = os.path.join(root, "phase3_model"), os.path.join(root, "bf16.pt2")
    fast_ckpt.save_packed(checkpoint, ckpt.model_tree(model32))
    t1 = time.perf_counter()
    export_cli.main(export_cli.build_export_parser().parse_args(
        [checkpoint, "-o", out, "-a", "resnet101", "--device", "cuda", "--image-size",
         str(IMAGE), "--heatmap-size", str(HEATMAP), "--uint8-input", "--bf16"]))
    export_s = time.perf_counter() - t1
    weights = serving.load_artifact_weights(out + ".weights.npz")
    if not all(v.dtype == torch.float32 for v in weights.values() if v.is_floating_point()):
        raise AssertionError("bf16 artifact: its weights are not float32")
    model16 = build_model(torch, models, dtype=torch.bfloat16).cuda()
    mean = torch.as_tensor(IMAGENET_MEAN, device="cuda")
    std = torch.as_tensor(IMAGENET_STD, device="cuda")
    kw = dict(image_size=IMAGE, heatmap_size=HEATMAP, uint8_input=True, device="cuda")
    predict16 = evaluate.make_predict_fn(model16, **kw)
    predict32 = evaluate.make_predict_fn(model32, **kw)
    rng = np.random.default_rng(90)
    requests = {n: (rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8), reps)
                for n, reps in ((1, 30), (8, 20), (32, 10))}
    in_process = {n: {"eager_ms": host_ms(torch, lambda f=f: [t.cpu() for t in predict16(f)],
                                          reps)} for n, (f, reps) in requests.items()}
    server = serve.create_server(serve.build_serve_parser().parse_args(
        [out, "--host", "127.0.0.1", "--port", "0", "--batch-window", "2",
         "--device", "cuda"]))  # sets cuDNN deterministic, as phase 7's do
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    checked = {}
    try:
        with PoseClient("127.0.0.1", server.server_address[1], timeout=120) as client:
            timing = _timed_requests(client, requests)
            http = {n: client.predict(f) for n, (f, _) in requests.items()}
        servable = server.servable
        for n, (frames, reps) in requests.items():
            in_process[n]["dispatch_ms"] = host_ms(torch, lambda f=frames: servable.run_arrays(f),
                                                   reps)
            coords16, _ = predict16(frames)
            if not np.array_equal(http[n][0], coords16.cpu().numpy()):
                raise AssertionError(f"bf16 artifact at {n} frames: coordinates differ from "
                                     "the bfloat16 eager predict")
            # against float32: equal wherever the float32 top-2 gap exceeds
            # twice the bfloat16 heatmap's largest deviation from it
            coords32, _ = predict32(frames)
            with torch.no_grad():
                xs = (torch.from_numpy(frames).cuda().float() / 255.0 - mean) / std
                y32 = model32.main_head(model32.features(xs)).reshape(n, -1, JOINTS)
                y16 = model16.main_head(model16.features(xs)).float().reshape(n, -1, JOINTS)
            dev = (y16 - y32).abs().amax(dim=1)
            top2 = y32.topk(2, dim=1).values
            sure = ((top2[:, 0] - top2[:, 1]) > 2 * dev).cpu()
            c16, c32 = torch.from_numpy(http[n][0]), coords32.cpu()
            if not torch.equal(c16[sure], c32[sure]):
                raise AssertionError(f"bf16 artifact at {n} frames: coordinates differ from "
                                     "float32 where bfloat16 cannot move the argmax")
            dist = (c16 - c32).norm(dim=-1)
            checked[n] = {"equal_bf16_eager": True, "joints": int(sure.numel()),
                          "sure_joints_equal_float32": int(sure.sum()),
                          "px_from_float32_mean": float(dist.mean()),
                          "px_from_float32_max": float(dist.max()),
                          "heatmap_max_dev_from_float32": float(dev.max())}
        graphs = servable.info()["graphs"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        torch.backends.cudnn.deterministic = False
    shutil.rmtree(root, ignore_errors=True)
    line("phase 9c serving --bf16 artifact resnet101 256²/64²/21", {
        "card": smi, "seconds": time.perf_counter() - t0, "cli_export_s": export_s,
        "requests_http": timing, "in_process": in_process, "checks": checked,
        "graphs_captured": graphs, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})


# ------------------------------------------------------------------ phase 10
PARALLEL_WORLD = 2  # ranks of phases 10b and 10c, sharing the card over gloo
WORKER_TIMEOUT = 600  # seconds a phase-10 rank may take
DATA_PARALLEL_ATOL = 1e-4  # parameters, W ranks vs 1 process (tests/test_parallel.py:60-83)
# BN statistics, W ranks vs 1 process: at most this many times float32's own
# rounding there (world 1 in float32 against float64 on the same draws), the
# criterion PERF.md §6 wrote down before the gap was measured
BN_FLOOR_FACTOR = 2.0


def rank_env(port: int, rank: int, world: int, backend: str | None = None) -> dict:
    """The ``DAHPE_*`` rendezvous of one rank on the loopback, explicit
    timeouts; ``backend`` overrides the device's (NCCL on the card)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DAHPE_")}
    env.update(DAHPE_COORDINATOR=f"127.0.0.1:{port}", DAHPE_NUM_PROCESSES=str(world),
               DAHPE_PROCESS_ID=str(rank), DAHPE_DIST_INIT_TIMEOUT="300",
               DAHPE_DIST_INIT_RETRIES="3")
    if backend:
        env["DAHPE_DIST_BACKEND"] = backend
    return env


def parallel_draws(torch, device, world: int = PARALLEL_WORLD):
    """The global batch's draws for phase 10b, one set a domain: 32 row
    indices, rank r's ``32 / world`` rows from the r-th of ``world`` equal
    parts of the 256-row store (its shard), and their augmentation
    draws."""
    from dahpe_tpu_torch.data.device_aug import draw_augment_params

    out = []
    for domain in range(2):
        gen = torch.Generator(device=device).manual_seed(31 + domain)
        rows, shard = BATCH // world, 256 // world
        idx = torch.cat([torch.randperm(shard, generator=gen, device=device)[:rows] + shard * r
                         for r in range(world)])
        out.append((idx, draw_augment_params(gen, BATCH, size=RAW)))
    return out


def worker_step(torch, device, rank, outdir):
    """Phase 10b, one rank: its shards of phase 5's stores, its rows of the
    global batch, one parallel DA iteration (counted, then timed), the
    collectives timed alone, and the replicas compared. cuDNN
    deterministic, as the world-1 iteration it is compared with."""
    import torch.distributed as dist

    from dahpe_tpu_torch import data, models, parallel, train
    from dahpe_tpu_torch.ops import gaussian, pseudo_label, shear

    torch.backends.cudnn.deterministic = True
    kernels = Kernels(gaussian, pseudo_label, shear)
    world = parallel.world_size()
    stores = [data.DeviceDataStore(SyntheticSplit(256, RAW, seed=seed), device=device,
                                   raw_size=RAW, verbose=False, shard=(rank, world))
              for seed in (2, 3)]
    model = build_model(torch, models, seed=9).to(device)
    state = train.create_da_state(model, device=device, with_ema=True)
    step = parallel.make_parallel_da_step(model, share_target_features=True, ema_decay=0.99)
    part = BATCH // world
    rows = slice(rank * part, (rank + 1) * part)

    def batches():
        return [store.train_batch_from(idx[rows] - store.n * rank,
                                       {k: v[rows] for k, v in params.items()})
                for store, (idx, params) in zip(stores, parallel_draws(torch, device, world))]

    kernels.reset()
    b_s, b_t = batches()
    state, m = step(state, b_s, b_t)
    torch.cuda.synchronize()
    launches = kernels.read()
    result = {"losses": {k: float(m[k]) for k in ("loss_s", "loss_gf", "loss_gt")},
              "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
              "launches": launches,
              "parameters_equal": parallel.assert_replicated(list(model.parameters())),
              "state_tensors_equal": parallel.assert_replicated(state)}
    snap = take(state, [])
    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, *batches())
    torch.cuda.synchronize()
    result["ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / iters
    # the collectives alone: each call between two synchronizes (so its
    # time is its own, not its inputs'), in one more iteration
    spent, real = [0.0, 0], {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            spent[1] += 1
            return out
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        t0 = time.perf_counter()
        state, m = step(state, *batches())
        torch.cuda.synchronize()
        synced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    put(torch, state, [], snap)
    result.update(collective_calls_per_iter=spent[1], collective_ms_per_iter=spent[0] * 1e3,
                  synchronized_iter_ms=synced_ms, collective_share=spent[0] * 1e3 / synced_ms)
    return result


def worker_cli(torch, device, rank, outdir):
    """Phase 10c, one rank: ``cli.train --multihost --device-store`` at full
    width on phase 6's cut data (its own log directory per rank, rank 0
    alone may write): a pretrain epoch and a DA epoch cut by ``--max-steps
    4``, in which rank 1 alone raises SIGTERM after its first DA call;
    ``--resume`` to 4; a straight run from the pretrain checkpoint to 4.
    cuDNN deterministic, for the bit-for-bit comparison."""
    import signal

    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.ops import gaussian, pseudo_label, shear

    register_cut_domains()
    torch.backends.cudnn.deterministic = True
    kernels = Kernels(gaussian, pseudo_label, shear)

    def argv(name, *extra):
        return build_parser("train").parse_args([
            "unused", "-s", "SyntheticHandsSource", "-t", "SyntheticHandsTarget",
            "-a", CLI_ARCH, "--device", CLI_DEVICE, "-b", str(BATCH), "--image-size", str(IMAGE),
            "--heatmap-size", str(HEATMAP), "--device-store", "--with-ema", "--multihost",
            "--print-freq", "2", "--workers", "4", "--seed", "3", "-i", "4", "--epochs", "1",
            "--max-steps", "4", "--log", os.path.join(outdir, f"{name}_{rank}"), *extra])

    steps = []
    real = train_cli.make_fused_da_iteration

    def signalling(*a, **kw):
        call = real(*a, **kw)

        def run(state, *gens):
            out = call(state, *gens)
            steps.append(out[0].step)
            if rank == 1 and len(steps) == 1:  # rank 1 alone is told to stop
                signal.raise_signal(signal.SIGTERM)
            return out
        return run

    kernels.reset()
    t0 = time.perf_counter()
    train_cli.make_fused_da_iteration = signalling
    try:
        train_cli.main(argv("drain", "--pretrain-epochs", "1"))
    finally:
        train_cli.make_fused_da_iteration = real
    drain = {"steps": list(steps), "seconds": time.perf_counter() - t0}
    ckdir = os.path.join(outdir, f"drain_{rank}", "checkpoints")
    t0 = time.perf_counter()
    train_cli.main(argv("drain", "--resume", os.path.join(ckdir, "latest")))
    resume_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_cli.main(argv("straight", "--pretrain", os.path.join(ckdir, "pretrain")))
    torch.cuda.synchronize()
    return {"drain": drain, "resume_s": resume_s, "straight_s": time.perf_counter() - t0,
            "launches": kernels.read(),
            "wrote": sorted(n for n in os.listdir(outdir) if n.endswith(f"_{rank}"))}


WORKERS = {"step": worker_step, "cli": worker_cli}


def worker_main(job: str, outdir: str) -> int:
    """One rank of a phase-10 job (``chip_smoke.py --worker JOB DIR``):
    bring-up through the ``DAHPE_*`` environment, the job, its result in
    ``DIR/rank{r}.pt``."""
    import torch

    from dahpe_tpu_torch import parallel

    device = parallel.robust_distributed_initialize(CLI_DEVICE)
    try:
        result = WORKERS[job](torch, device, parallel.rank(), outdir)
        torch.save(result, os.path.join(outdir, f"rank{parallel.rank()}.pt"))
    finally:
        parallel.shutdown()
    return 0


def run_workers(torch, job: str, outdir: str, world: int = PARALLEL_WORLD,
                backend: str = "gloo") -> list[dict]:
    """``world`` ranks of ``job``, each a process of this script, over
    ``backend``: gloo to share one card (NCCL refuses two ranks on one
    device), NCCL for one rank a card; their logs in ``outdir``. Any rank
    that fails fails the phase."""
    from dahpe_tpu_torch.parallel.launch import free_port

    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", job,
                               outdir], env=rank_env(port, r, world, backend),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        with open(os.path.join(outdir, f"rank{r}.log"), "w") as fh:
            fh.write(out)
        if p.returncode != 0:
            raise AssertionError(f"phase 10 {job}: rank {r} exited {p.returncode}:\n{out[-3000:]}")
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def phase_parallel_world1(torch, models, train, data, smi, phase5_ms, phase8a):
    """Phase 10a: the data-parallel DA iteration at world size 1 over NCCL
    (the ``DAHPE_*`` contract on the loopback, in this process), at phase
    5's configuration. Every collective is issued at world 1 (the gradient
    all-reduces, the metrics' mean), so NCCL runs; batch norm is the local
    layer. cuDNN deterministic for the checks, whose noise floors (the same
    runs twice) must be bit for bit: 2 iterations equal the iteration
    without a group bit for bit, and a K = 4 graph with the NCCL
    collectives captured equals 4 eager calls bit for bit and holds the
    path kernels of one eager iteration as nodes. Then, at cuDNN's
    defaults as phases 5 and 8a run, ms/iter at K = 1 with and without the
    collectives in turns and at K = 4 replayed, NCCL's device time, the
    collective calls an iteration issues and its host syncs."""
    import torch.distributed as dist

    from dahpe_tpu_torch import parallel
    from dahpe_tpu_torch.parallel.launch import free_port

    t0 = time.perf_counter()
    saved_env = {k: v for k, v in os.environ.items() if k.startswith("DAHPE_")}
    os.environ.update(rank_env(free_port(), 0, 1))
    parallel.robust_distributed_initialize(CLI_DEVICE)
    try:
        if (dist.get_backend() != parallel.distributed.backend_for(CLI_DEVICE)
                or dist.get_world_size() != 1):
            raise AssertionError(f"10a: {dist.get_backend()} over {dist.get_world_size()} ranks")
        stores = [data.DeviceDataStore(SyntheticSplit(256, RAW, seed=seed), device=CLI_DEVICE,
                                       raw_size=RAW, verbose=False) for seed in (2, 3)]
        model = build_model(torch, models, seed=9).to(CLI_DEVICE)
        state = train.create_da_state(model, device=CLI_DEVICE, with_ema=True)
        gens = [stores[0].generator(11), stores[1].generator(12)]
        collectives = parallel.data_parallel(model)  # world 1: batch norm stays local

        def make_call(k, with_group=True):
            extra = collectives if with_group else {}
            fused = train.make_fused_da_iteration(model, stores[0], stores[1], BATCH,
                                                  steps_per_call=k, share_target_features=True,
                                                  ema_decay=0.99, **extra)
            return lambda: fused(state, *gens)[1]

        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            plain, single = make_call(1, with_group=False), make_call(1)
            for fn in (plain, plain, single):  # cuDNN's algorithms; NCCL's communicator
                fn()
            snap = take(state, gens)
            runs = {}
            for name, fn in (("no_group", plain), ("world_1", single), ("no_group_again", plain)):
                put(torch, state, gens, snap)
                fn()
                fn()
                runs[name] = take(state, gens)
            floor = state_agreement(torch, runs["no_group_again"][0], runs["no_group"][0])
            vs_no_group = state_agreement(torch, runs["world_1"][0], runs["no_group"][0])
            if not all(torch.equal(a, b) for a, b in zip(runs["world_1"][2], runs["no_group"][2])):
                raise AssertionError("10a: the generators differ from the run without a group")
            # the bit-for-bit checks need a bit-for-bit floor: without one they
            # could not tell a dropped launch from noise
            if not floor["bit_equal"]:
                raise AssertionError(f"10a: two runs without a group differ with cuDNN "
                                     f"deterministic: {floor}")
            if not vs_no_group["bit_equal"]:
                raise AssertionError(f"10a: world 1 over NCCL differs from the iteration without "
                                     f"a group: {vs_no_group}")
            # K = 4: the captured graph (NCCL inside) against 4 eager calls
            eager = []
            for _ in range(2):
                put(torch, state, gens, snap)
                for _ in range(GRAPH_K):
                    single()
                eager.append(take(state, gens))
            chunked = make_call(GRAPH_K)
            put(torch, state, gens, snap)
            chunked()  # the first call: GRAPH_K eager iterations on the capture's stream
            put(torch, state, gens, snap)
            # the capture, then GRAPH_K replays; the graph's kernel nodes counted
            per_graph = graph_kernel_nodes(torch, chunked, PATH_KERNEL_NAMES)
            graphed = take(state, gens)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        eager_floor = state_agreement(torch, eager[1][0], eager[0][0])
        replay = state_agreement(torch, graphed[0], eager[0][0])
        if graphed[1] != eager[0][1] or not all(torch.equal(a, b)
                                                for a, b in zip(graphed[2], eager[0][2])):
            raise AssertionError("10a: the replayed chunk's step or generators differ")
        if not eager_floor["bit_equal"]:
            raise AssertionError(f"10a: two eager runs differ with cuDNN deterministic: "
                                 f"{eager_floor}")
        if not replay["bit_equal"]:
            raise AssertionError(f"10a: the graph with NCCL inside differs from eager: {replay}")
        chunked = make_call(GRAPH_K)
        chunked()
        chunked()
        plain()
        single()  # at cuDNN's defaults
        # eager with and without the collectives in turns, then replayed
        times = {}
        for name, fn in (("k1_no_group", plain), ("k1_world_1", single),
                         ("k1_world_1", single), ("k1_no_group", plain)):
            times.setdefault(name, []).append(timed_calls(torch, fn, 5, 1, 2 * BATCH))
        times[f"k{GRAPH_K}_world_1_replayed"] = timed_calls(torch, chunked, 2, GRAPH_K,
                                                            2 * BATCH)
        eager_profile = device_profile(torch, single)
        replay_profile = device_profile(torch, chunked)
        nccl = {}
        for name, prof in (("k1_eager", eager_profile), (f"k{GRAPH_K}_replayed", replay_profile)):
            per = 1 if name == "k1_eager" else GRAPH_K
            nccl[name] = {"nccl_kernel_ms_per_iter": prof.get("by_kind_ms", {}).get(
                "collective", 0.0) / per, "device_busy_ms_per_iter": prof.get(
                "device_busy_ms", 0.0) / per, "idle_share": prof.get("idle_share"),
                "top_ms": prof.get("top_ms")}
        # the collective calls one eager iteration issues (at one rank NCCL
        # may launch no kernel of its own for them)
        issued, real = {}, {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

        def counting(name, fn):
            def call(*a, **kw):
                issued[name] = issued.get(name, 0) + 1
                return fn(*a, **kw)
            return call

        for name, fn in real.items():
            setattr(dist, name, counting(name, fn))
        try:
            single()
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        if not issued.get("all_reduce"):
            raise AssertionError(f"10a: the iteration issued no all-reduce: {issued}")
        # host syncs in one eager iteration, as torch's sync debug mode reports them
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                single()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sorted({str(w.message).splitlines()[0][:120] for w in caught
                        if "synchronizing CUDA operation" in str(w.message)})
        per_eager = {k: eager_profile["port_kernel_launches"][k] for k in PATH_KERNEL_NAMES}
        per_replay = {k: replay_profile["port_kernel_launches"][k] / GRAPH_K
                      for k in PATH_KERNEL_NAMES}
        # what a replay runs is the captured graph's kernel nodes, read from
        # the graph itself; the profiler's count of a replay is reported
        # beside them (one full run's profile on an NVIDIA H100 80GB HBM3 at
        # 700 W listed 6.5 / 2.25 / 2)
        if per_eager != dict(zip(PATH_KERNEL_NAMES, (7, 3, 2))) or per_graph != per_eager:
            raise AssertionError(f"10a: path kernel nodes in the captured graph {per_graph}, "
                                 f"per eager iteration {per_eager}")
        line("phase 10a data parallel world 1 over NCCL resnet101 256²/64²/21, batch 32+32", {
            "card": smi, "seconds": time.perf_counter() - t0, "backend": dist.get_backend(),
            "vs_no_group_2_iters": {"generators_equal": True, **vs_no_group},
            "no_group_vs_no_group": floor, "cudnn_deterministic_for_the_checks": True,
            "graph_vs_eager": {"generators_equal": True, "steps_equal": True, **replay},
            "eager_vs_eager": eager_floor, "times": times,
            "phase5_no_group_ms_per_iter": phase5_ms, "phase8a_no_group_times": phase8a,
            "collectives": nccl, "collective_calls_per_iter": issued, "host_syncs": syncs,
            "path_kernels_per_eager_iteration": per_eager,
            "path_kernel_nodes_in_the_graph": per_graph,
            "path_kernels_per_replay_profiled": per_replay})
        return stores
    finally:
        parallel.shutdown()
        for k in [k for k in os.environ if k.startswith("DAHPE_")]:
            del os.environ[k]
        os.environ.update(saved_env)


def phase_parallel_two_ranks(torch, models, train, smi, stores, root,
                             world: int = PARALLEL_WORLD, backend: str = "gloo",
                             floor_worlds=()):
    """Phase 10b: two ranks sharing the card over gloo (or, with ``--cards``,
    one rank a card over NCCL), one DA iteration at global batch 32+32
    (32/W + 32/W a rank, each rank's rows from its shard) against the same
    iteration at world 1 on the same global batch, from the same weights:
    losses within rel 1e-4, every parameter within ``DATA_PARALLEL_ATOL``
    and every BN statistic within ``BN_FLOOR_FACTOR`` times the float64
    floor on the same draws (below); the ranks' launches (7 / 3 / 2 an iteration),
    ms/iter and the collectives' share. cuDNN deterministic on both sides:
    at its defaults some algorithms sum in a varying order, and the
    world-1 iteration alone then moved a BN statistic by 9.2e-5 between
    runs on an NVIDIA H100 80GB HBM3 at 700 W, so the gap would be noise. Beside the gap, the world-1
    iteration at cuDNN's defaults against the deterministic one, and the
    float64 floor that bounds the BN gap (PERF.md §6): the world-1
    iteration in float64 against the float32 one (float32's own rounding)
    on the W-rank draws, and the ranks against float64; ``floor_worlds``
    adds that floor on the global batches of other world sizes (the 4-rank
    draws on one card)."""
    t0 = time.perf_counter()
    ranks = run_workers(torch, "step", os.path.join(root, "10b"), world, backend)

    def world_1(w, deterministic, dtype=None):
        """One world-1 DA iteration on the global batch of ``w`` ranks'
        draws, from the ranks' weights, in ``dtype`` (default float32)."""
        model = build_model(torch, models, seed=9).to(CLI_DEVICE)  # the ranks' weights
        batches = [store.train_batch_from(idx, params) for store, (idx, params)
                   in zip(stores, parallel_draws(torch, CLI_DEVICE, w))]
        if dtype is not None:
            model.to(dtype)
            batches = [{k: v.to(dtype) for k, v in b.items()} for b in batches]
        state = train.create_da_state(model, device=CLI_DEVICE, with_ema=True)
        step = train.make_da_train_step(model, share_target_features=True, ema_decay=0.99)
        default = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            state, m = step(state, *batches)
        finally:
            torch.backends.cudnn.deterministic = default
        return ({k: float(m[k]) for k in ("loss_s", "loss_gf", "loss_gt")},
                {k: v.detach().cpu() for k, v in model.state_dict().items()},
                {n for n, _ in model.named_parameters()})

    want, ref, params = world_1(world, True)

    def gap(got, base=ref):
        """The worst |Δ| of each kind against ``base``, and where: (tensor,
        its largest |value|)."""
        worst, at = {"parameters": 0.0, "bn_statistics": 0.0}, {}
        for k, v in base.items():
            if v.is_floating_point():
                kind = "parameters" if k in params else "bn_statistics"
                diff = float((got[k].double() - v.double()).abs().max())
                if diff > worst[kind]:
                    worst[kind], at[kind] = diff, (k, float(v.abs().max()))
        return {"worst_abs": worst, "at_tensor_and_its_largest_abs": at}

    floor = gap(world_1(world, False)[1])
    f64 = world_1(world, True, torch.float64)[1]
    rounding = gap(f64)  # float32's own rounding: world-1 float32 against float64
    floors = {w: gap(*(world_1(w, True, dtype)[1] for dtype in (None, torch.float64)))
              for w in floor_worlds}
    worst = {"worst_abs": {"parameters": 0.0, "bn_statistics": 0.0}}
    ranks_vs_f64 = 0.0
    for r, res in enumerate(ranks):
        ranks_vs_f64 = max(ranks_vs_f64, gap(res["state"], f64)["worst_abs"]["bn_statistics"])
        rel = max(abs(res["losses"][k] - v) / abs(v) for k, v in want.items())
        if not rel <= 1e-4:
            raise AssertionError(f"10b: rank {r} losses {res['losses']} vs world 1 {want}")
        mine = gap(res["state"])
        if max(mine["worst_abs"].values()) > max(worst["worst_abs"].values()):
            worst = mine
        expected = dict(NO_LAUNCHES, render_gaussian=7, pseudo_labels=3, rotate3_fused=2)
        if res["launches"] != expected:
            raise AssertionError(f"10b: rank {r} launches {res['launches']}, expected {expected}")
    bn_gap = worst["worst_abs"]["bn_statistics"]
    bn_rounding = floors.get(world, rounding)["worst_abs"]["bn_statistics"]
    bounds = {"parameters": DATA_PARALLEL_ATOL, "bn_statistics": BN_FLOOR_FACTOR * bn_rounding}
    classification = {
        "criterion": f"fault if the W-rank BN-statistics gap exceeds {BN_FLOOR_FACTOR}x the "
                     "world-1 float32-vs-float64 gap on the same draws",
        "w_rank_gap": bn_gap, "float32_vs_float64": bn_rounding,
        "ranks_vs_float64": ranks_vs_f64, "gap_over_rounding": bn_gap / bn_rounding,
        "float64_floor_other_worlds": floors,
    }
    if not all(worst["worst_abs"][kind] <= bound for kind, bound in bounds.items()):
        raise AssertionError(f"10b: {world} ranks vs world 1 {worst} against {bounds}; world 1 "
                             f"at cuDNN's defaults vs deterministic {floor}; float64 floor "
                             f"{classification}")
    keys = ("ms_per_iter", "collective_calls_per_iter", "collective_ms_per_iter",
            "synchronized_iter_ms", "collective_share", "parameters_equal",
            "state_tensors_equal", "launches")
    where = ("sharing the card over gloo" if backend == "gloo"
             else f"one a card over {backend}")
    line(f"phase 10b data parallel {world} ranks {where}, resnet101, batch 32+32", {
        "card": smi, "seconds": time.perf_counter() - t0, "losses_world_1": want,
        "losses_rank_0": ranks[0]["losses"], "vs_world_1": worst,
        "cudnn_deterministic": True, "world_1_default_vs_deterministic": floor,
        "world_1_float32_vs_float64": rounding, "bn_classification": classification,
        "bounds": bounds, "ranks": [{k: res[k] for k in keys} for res in ranks]})
    return [res["launches"] for res in ranks]


def phase_parallel_cli(torch, smi, root):
    """Phase 10c: ``cli.train --multihost`` on two ranks sharing the card over
    gloo (``worker_cli``): SIGTERM to rank 1 alone drains both at one step,
    rank 0 alone writes, and ``--resume`` ends bit for bit where a straight
    run from the same warm start ends."""
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    t0 = time.perf_counter()
    outdir = os.path.join(root, "10c")
    ranks = run_workers(torch, "cli", outdir)
    drained = [res["drain"]["steps"] for res in ranks]
    if drained[0] != drained[1] or drained[0][-1] != 2:
        raise AssertionError(f"10c: the ranks drained after steps {drained}, expected both at 2")
    if ranks[0]["wrote"] != ["drain_0", "straight_0"] or ranks[1]["wrote"]:
        raise AssertionError(f"10c: directories written {[r['wrote'] for r in ranks]}")
    resumed = os.path.join(outdir, "drain_0", "checkpoints", "latest")
    straight = os.path.join(outdir, "straight_0", "checkpoints", "latest")
    flat_r = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(resumed))
    flat_s = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(straight))
    if [p for p, _ in flat_r] != [p for p, _ in flat_s]:
        raise AssertionError("10c: the resumed and straight checkpoints hold different trees")
    unequal = ["/".join(p) for (p, a), (_, b) in zip(flat_r, flat_s) if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"10c: resumed differs from straight at {unequal[:5]}")
    aux_r, aux_s = ckpt.load_aux(resumed), ckpt.load_aux(straight)
    if not all(aux_r[k].shape[0] == PARALLEL_WORLD and np.array_equal(aux_r[k], aux_s[k])
               for k in ("key_s", "key_t")):
        raise AssertionError("10c: the ranks' sampling states did not continue")
    # per rank: pretrain 4 steps (1 + 1) and 2 val batches (1), DA 2 + 2 + 4
    # iterations (7 / 3 / 2)
    expected = dict(NO_LAUNCHES, render_gaussian=4 + 2 + 7 * 8, pseudo_labels=3 * 8,
                    rotate3_fused=4 + 2 * 8)
    for r, res in enumerate(ranks):
        if res["launches"] != expected:
            raise AssertionError(f"10c: rank {r} launches {res['launches']}, expected {expected}")
    shutil.rmtree(outdir, ignore_errors=True)  # the checkpoints: several GB
    line("phase 10c training CLI --multihost, 2 ranks over gloo, resnet101 256²/64², batch 32", {
        "card": smi, "seconds": time.perf_counter() - t0, "drained_after_steps": drained,
        "only_rank_0_wrote": True, "resume_bit_equal": True,
        "tensors_compared": len(flat_r),
        "ranks": [{k: res[k] for k in ("drain", "resume_s", "straight_s", "launches")}
                  for res in ranks]})
    return [res["launches"] for res in ranks]


def phase_serve_mesh(torch, smi, root):
    """Phase 10d: ``cli.serve --mesh`` on the float artifact in ``root``
    (phase 7's), against the server without it, at 1, 8 and 32 frames:
    equal coordinates. ``root`` is deleted after."""
    from dahpe_tpu_torch.cli import serve

    t0 = time.perf_counter()
    artifact = os.path.join(root, "float.pt2")
    servers = [serve.create_server(serve.build_serve_parser().parse_args(
        [artifact, "--port", "0", *extra])) for extra in ((), ("--mesh",))]
    rng = np.random.default_rng(101)
    results = {}
    try:
        for n in (1, 8, 32):
            frames = rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
            (c0, m0), (c1, m1) = [s.servable.run_arrays(frames) for s in servers]
            if not np.array_equal(c0, c1):
                raise AssertionError(f"10d: --mesh coordinates differ at {n} frames")
            results[n] = {"coords_equal": True, "maxvals_max_abs": float(np.abs(m0 - m1).max()),
                          "mesh_dispatch_ms": host_ms(torch, lambda: servers[1].servable
                                                      .run_arrays(frames), 10)}
        info = servers[1].servable.info()
    finally:
        for s in servers:
            s.server_close()
    shutil.rmtree(root, ignore_errors=True)
    line(f"phase 10d cli.serve --mesh over {len(info['devices'])} card(s), float artifact "
         "resnet101 256²/64²/21", {
        "card": smi, "seconds": time.perf_counter() - t0, "devices": info["devices"],
        "graphs": info["graphs"], "frames": results})


HOST_WARP_WORKERS = 8  # phase 11a: loader threads (the card's machine has 8 cores)
DRILL_ITERS = 16  # phase 11c: iterations an epoch (the drill's default 100)
AUDIT_ITERS, AUDIT_REPEATS = 30, 9  # phase 11b: calls a timed loop, loops a prefix


def cli_train_main(argv) -> int:
    """``chip_smoke.py --cli-train ARGS``: ``cli.train`` on phase 6's cut
    synthetic domains, then one line of this process's kernel launches
    (the training CLI that phase 11c's drill drives)."""
    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.ops import gaussian, pseudo_label, shear

    register_cut_domains()
    kernels = Kernels(gaussian, pseudo_label, shear)
    kernels.reset()
    rc = train_cli.cli_main(argv)
    print("chip_smoke launches " + json.dumps(kernels.read()), flush=True)
    return rc


def phase_host_warp(torch, kernels, smi):
    """Phase 11a: ``cli.train --host-warp`` at full width (ResNet-101,
    256²/64², batch 32, float32) on phase 6's cut synthetic domains: the
    native library's build, one batch of its fused augmentation against
    the numpy version (``tests/test_native.py``'s rtol/atol 1e-3), the
    warped loader's img/s with ``HOST_WARP_WORKERS`` threads against the
    DA loop's demand, then a pretrain epoch (PIL batches) and a DA epoch
    (warped batches through the decoded cache, Gaussian targets and
    pseudo-labels on the card): ms/iter in the loop, the profiled
    iteration's idle share, and the launches the counts imply."""
    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.cli.common import maybe_decoded_cache
    from dahpe_tpu_torch.data import BatchLoader, get_dataset, host_warp
    from dahpe_tpu_torch.utils import native

    t0 = time.perf_counter()
    _, build = native.build()
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (BATCH, RAW, RAW, 3), dtype=np.uint8)
    worst = 0.0
    for img in frames:
        mat, off, _, _, _ = host_warp.sample_affine(rng, RAW, RAW, IMAGE, 180.0, (0.6, 1.3))
        ops, factors, sigma = rng.permutation(3), rng.uniform(0.75, 1.25, 3), rng.uniform(0, 0.8)
        got = native.fused_augment(img, mat, off, IMAGE, ops, factors, sigma)
        want = host_warp.augment_plain(img, mat, off, IMAGE, ops, factors, sigma)
        if not np.allclose(got, want, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"11a: native warp vs numpy {np.abs(got - want).max()}")
        worst = max(worst, float(np.abs(got - want).max()))

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_warp")
    shutil.rmtree(root, ignore_errors=True)
    register_cut_domains()
    iters, profiled = 8, 1
    argv = ["unused", "-s", "SyntheticHandsSource", "-t", "SyntheticHandsTarget", "-a", CLI_ARCH,
            "--device", CLI_DEVICE, "-b", str(BATCH), "--image-size", str(IMAGE),
            "--heatmap-size", str(HEATMAP), "--host-warp", "--workers", str(HOST_WARP_WORKERS),
            "--print-freq", "100", "--seed", "3", "--decoded-cache", os.path.join(root, "cache"),
            "--pretrain-epochs", "1", "--epochs", "1", "-i", str(iters), "--profile",
            str(profiled), "--log", os.path.join(root, "run")]
    args = build_parser("train").parse_args(argv)
    source = maybe_decoded_cache(args, get_dataset(
        "SyntheticHandsSource", root="unused", image_size=(IMAGE, IMAGE),
        heatmap_size=(HEATMAP, HEATMAP)))
    loader = BatchLoader(source, BATCH, num_workers=HOST_WARP_WORKERS, seed=0, warped=True,
                         image_size=IMAGE)
    stamps = [time.perf_counter() for _ in loader]  # one epoch; the first batch warms up
    loader_img_s = (len(stamps) - 1) * BATCH / (stamps[-1] - stamps[0])

    starts = []
    real_step = train_cli.make_da_train_step

    def timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def timed(*args):
            starts.append(time.perf_counter())
            return step(*args)
        return timed

    kernels.reset()
    train_cli.make_da_train_step = timed_step
    t1 = time.perf_counter()
    try:
        train_cli.main(args)
    finally:
        train_cli.make_da_train_step = real_step
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = kernels.read()
    loop = starts[2 + profiled:]
    ms = (loop[-1] - loop[0]) * 1e3 / (len(loop) - 1)
    records = [json.loads(r) for r in open(os.path.join(root, "run", "metrics.jsonl"))]
    da = records[-1]
    if [r["kind"] for r in records] != ["pretrain_epoch", "da_epoch"] or not all(
            np.isfinite(da[k]) for k in ("loss_s", "loss_gf", "loss_gt")):
        raise AssertionError(f"11a: metrics {records}")
    with open(os.path.join(root, "run", "trace", "summary.json")) as fh:
        profile = json.load(fh)
    # 7 / 3 / 0 a DA iteration (2 targets in finalize_batch, 5 in the
    # step; no rotation on the host-fed path), 1 a pretrain step, 1 an
    # eval batch (source after the pretrain, source and target after DA)
    val_batches = -(-CLI_VAL // BATCH)
    da_iters = 2 + profiled + iters
    expected = dict(NO_LAUNCHES, render_gaussian=7 * da_iters + iters + 3 * val_batches,
                    pseudo_labels=3 * da_iters)
    if launches != expected:
        raise AssertionError(f"11a: launches {launches}, expected {expected}")
    shutil.rmtree(root, ignore_errors=True)
    line("phase 11a cli.train --host-warp resnet101 256²/64², batch 32, float32", {
        "card": smi, "seconds": time.perf_counter() - t0,
        "native_build": {"built": build["built"], "seconds": build["seconds"]},
        "native_vs_numpy": {"max_abs_err": worst, "rtol": 1e-3, "atol": 1e-3},
        "loader": {"workers": HOST_WARP_WORKERS, "img_per_s": loader_img_s,
                   "batches": len(stamps)},
        "cli_ms_per_iter": ms, "loop_iterations_timed": len(loop),
        "demand_img_per_s": 2 * BATCH * 1e3 / ms, "run_s": run_s,
        "profile_one_iteration": profile, "target_pck": da["val_target"]["all"],
        "data_cut": {"train_frames": CLI_TRAIN, "val_frames": CLI_VAL},
        "launches": launches, "expected_launches": expected})
    return launches


def phase_perf_audit(torch, kernels, smi):
    """Phase 11b: ``experiments.perf_audit`` at phase 5's configuration
    (batch 32 from a 288² uint8 store of 256 frames, 256² out, 64² targets),
    float32 and bf16: each stage's device ms (CUDA-graph replays), the
    stages' sum (the last prefix) against the whole producer's ms (within
    10%), and the rotation and Gaussian kernels' launches against the count
    the warm-up calls and captures imply."""
    from dahpe_tpu_torch.data import DeviceDataStore
    from dahpe_tpu_torch.experiments import perf_audit

    t0 = time.perf_counter()
    store = DeviceDataStore(perf_audit.SeededFrames(256, RAW), device=CLI_DEVICE, raw_size=RAW,
                            verbose=False)
    runs, launches = {}, dict(NO_LAUNCHES)
    for name, dtype in (("float32", None), ("bf16", torch.bfloat16)):
        kernels.reset()
        audit = perf_audit.run_audit(store, batch=BATCH, image_size=IMAGE, heatmap_size=HEATMAP,
                                     dtype=dtype, iters=AUDIT_ITERS, repeats=AUDIT_REPEATS,
                                     verbose=False)
        torch.cuda.synchronize()
        counts = kernels.read()
        # timed_ms's warm-up calls and its capture; the graph's replays run no wrapper
        calls = 5 + 1
        want = dict(NO_LAUNCHES, rotate3_fused=7 * calls, render_gaussian=2 * calls)
        if counts != want:
            raise AssertionError(f"11b {name}: launches {counts}, expected {want}")
        share = audit["stages_sum_ms"] / audit["producer_ms"]
        if not 0.9 <= share <= 1.1:
            raise AssertionError(f"11b {name}: stages sum to {audit['stages_sum_ms']} ms, the "
                                 f"producer takes {audit['producer_ms']} ms")
        runs[name] = {**audit, "sum_over_producer": share, "launches": counts}
        for k, v in counts.items():
            launches[k] += v
    line("phase 11b perf_audit producer stages, batch 32, 288² store → 256², 64² targets", {
        "card": smi, "seconds": time.perf_counter() - t0, "runs": runs,
        "timing": f"CUDA events, median of {AUDIT_REPEATS} loops of {AUDIT_ITERS} replays "
                  "of one captured call, after 5 warm-up calls"})
    return launches


def phase_drill(torch, smi):
    """Phase 11c: ``experiments.preempt_drill`` through the port's CLI at
    full width (ResNet-101, 256²/64², batch 32, ``--device-store``, bf16,
    the drill's defaults) on phase 6's cut synthetic domains: SIGTERM lands
    mid-epoch, the preempted process exits 0 with ``latest`` mid-epoch, the
    resume prints the exact iteration, every epoch's checkpoint exists. Cut
    in depth: ``DRILL_ITERS`` iterations an epoch, 2 epochs, saves every 4,
    the signal after iteration 2. Its two processes' launches are read from
    their logs."""
    from dahpe_tpu_torch.experiments.preempt_drill import run_drill

    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_drill")
    shutil.rmtree(root, ignore_errors=True)
    result = run_drill(root, arch=CLI_ARCH, image_size=IMAGE, heatmap_size=HEATMAP,
                       batch=BATCH, iters=DRILL_ITERS, epochs=2, save_every=4,
                       signal_after_iter=2, print_freq=1, device=CLI_DEVICE, poll_s=0.5,
                       timeout_s=600, verbose=False,
                       command=(sys.executable, os.path.abspath(__file__), "--cli-train"))
    launches = dict(NO_LAUNCHES)
    for log in ("phase1.log", "phase2.log"):
        with open(os.path.join(root, log)) as fh:
            counts = json.loads(fh.read().rsplit("chip_smoke launches ", 1)[1].splitlines()[0])
        for k, v in counts.items():
            launches[k] += v
    # 7 / 3 / 2 a DA iteration over the 2 epochs, 1 Gaussian an eval batch
    # (source and target after each epoch; the preempted process validates
    # nothing)
    da_iters, val_batches = 2 * DRILL_ITERS, -(-CLI_VAL // BATCH)
    expected = dict(NO_LAUNCHES, render_gaussian=7 * da_iters + 2 * 2 * val_batches,
                    pseudo_labels=3 * da_iters, rotate3_fused=2 * da_iters)
    if launches != expected:
        raise AssertionError(f"11c: launches {launches}, expected {expected}")
    shutil.rmtree(root, ignore_errors=True)  # the checkpoints: several GB
    line("phase 11c preempt_drill cli.train --device-store --bf16 resnet101 256²/64², batch 32", {
        "card": smi, "seconds": time.perf_counter() - t0, "result": result,
        "checks": {"preempted_exit_0_latest_mid_epoch": True, "resume_exact_iteration": True,
                   "every_epoch_checkpoint": True},
        "cut": {"iters_per_epoch": DRILL_ITERS, "default_iters_per_epoch": 100, "epochs": 2,
                "save_every": 4, "signal_after_iter": 2, "train_frames": CLI_TRAIN,
                "val_frames": CLI_VAL},
        "launches": launches})
    return launches


def phase_regda(torch, models, smi):
    """Phase 11d: ``RegDAPoseResNet(resnet101)`` at full width with seeded
    weights: its eval output ``y_adv2`` (and ``y``, ``y_adv``) for 1 and 32
    frames on the card against the same model on the CPU, at phase 3's
    tolerance (rtol 2e-3, atol max(2e-4, 1e-4·std))."""
    t0 = time.perf_counter()
    model = seed_weights(torch, models.RegDAPoseResNet(models.resnet101(), num_keypoints=JOINTS),
                         seed=13)
    cpu_model = copy.deepcopy(model)
    model = model.to(CLI_DEVICE)
    rng = np.random.default_rng(13)
    results = {}
    for n in (1, 32):
        x = torch.from_numpy(rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32))
        with torch.no_grad():
            got = {k: v.cpu() for k, v in model(x.to(CLI_DEVICE)).items()}
            want = cpu_model(x)
        errs = {}
        for k in ("y", "y_adv", "y_adv2"):
            if tuple(got[k].shape) != (n, HEATMAP, HEATMAP, JOINTS):
                raise AssertionError(f"11d: {k} shape {tuple(got[k].shape)}")
            atol = max(2e-4, 1e-4 * float(want[k].std()))
            errs[k] = float((got[k] - want[k]).abs().max())
            if not torch.allclose(got[k], want[k], rtol=2e-3, atol=atol):
                raise AssertionError(f"11d: {k} card vs CPU at {n} frames, max abs {errs[k]}")
        results[n] = errs
    del model
    torch.cuda.empty_cache()
    line("phase 11d RegDAPoseResNet resnet101 256²/64²/21 eval, card vs CPU", {
        "card": smi, "seconds": time.perf_counter() - t0, "max_abs_err": results,
        "rtol": 2e-3, "atol": "max(2e-4, 1e-4·std)"})


# ------------------------------------------------------------------ phase 12
RANKS_WORLD = 2  # phase 12: ranks of the experiment, sharing the card over gloo
RANKS_PARITY_ITERS = 2  # 12a: pretrain, control and DA iterations each
RANKS_TIMED_ITERS = 50  # 12b
RANKS_WARM, RANKS_SYNCED = 10, 10  # 12b: DA calls before the clock; the last, synchronized
RANKS_PCK_TOL = 0.01  # 12a: each PCK of the ranks' result against one process
PCK_KEYS = ("source_val", "pretrain", "source_only", "da", "da_ema")
DA_LOSSES = ("loss_s", "loss_gf", "loss_gt")


def frame_memo(torch, path: str | None = None):
    """Make ``SyntheticHands.fetch_raw`` of this process render each frame
    once (the experiment renders its 1,280 frames anew in every run, ~35 s
    of host time): from ``path`` where an earlier process saved the memo,
    else rendered and kept. Returns ``(frames, undo)``; ``frames`` is the
    memo, for ``torch.save``."""
    from dahpe_tpu_torch.data.synthetic import SyntheticHands

    frames = torch.load(path, weights_only=False) if path else {}
    saved = SyntheticHands.__dict__.get("fetch_raw")
    real = SyntheticHands.fetch_raw

    def fetch_raw(self, index, rng, raw_size=288):
        key = (self.domain, self.seed, self.shift, self.content, self.style,
               self.samples[index], raw_size)
        if key not in frames:
            frames[key] = real(self, index, rng, raw_size)
        return frames[key]

    def undo():
        if saved is None:
            del SyntheticHands.fetch_raw
        else:
            SyntheticHands.fetch_raw = saved

    SyntheticHands.fetch_raw = fetch_raw
    return frames, undo


def global_draws(torch, world: int):
    """Make every ``DeviceDataStore`` of this process draw the global batch
    of a ``world``-rank job and keep its own rows, as 10b's
    :func:`parallel_draws`: ``batch / world`` row indices from each of the
    ``world`` equal parts of the store's rows (JAX's shard assignment),
    then the whole batch's augmentation draws, all from the one generator,
    which no rank folds its rank into. A store of every row keeps the whole
    batch, rank r's shard the rows of part r: one process and the ranks see
    the same global batches. Returns the undo."""
    from dahpe_tpu_torch.data.device_aug import draw_augment_params
    from dahpe_tpu_torch.data.device_store import DeviceDataStore

    def traced_batch_fn(self, batch_size, *, image_size=256, heatmap_size=64, rotation=180.0,
                        scale_range=(0.6, 1.3), sigma=2.0):
        rows, part = batch_size // world, self.n * self.world // world
        mine = slice(self.rank * batch_size // self.world,
                     (self.rank + 1) * batch_size // self.world)
        cfg = dict(image_size=image_size, heatmap_size=heatmap_size, sigma=sigma)

        def produce(generator):
            idx = torch.cat([torch.randperm(part, generator=generator, device=self.device)[:rows]
                             + part * r for r in range(world)])
            params = draw_augment_params(generator, batch_size, size=self.raw_size,
                                         rotation=rotation, scale_range=tuple(scale_range))
            return self.train_batch_from(idx[mine] - self.n * self.rank,
                                         {k: v[mine] for k, v in params.items()}, **cfg)

        return produce

    saved = DeviceDataStore.traced_batch_fn, DeviceDataStore._seed
    DeviceDataStore.traced_batch_fn = traced_batch_fn
    DeviceDataStore._seed = lambda self, seed: int(seed)

    def undo():
        DeviceDataStore.traced_batch_fn, DeviceDataStore._seed = saved
    return undo


def float64_models(torch):
    """Make the experiment's models compute in float64: built (and drawn)
    in float32 as ever, then converted. Returns the undo."""
    from dahpe_tpu_torch import models

    saved = models.PoseResNet, models.MultiHeadPoseResNet

    def converted(cls):
        return lambda *a, **kw: cls(*a, **kw).to(torch.float64)

    models.PoseResNet, models.MultiHeadPoseResNet = (converted(c) for c in saved)

    def undo():
        models.PoseResNet, models.MultiHeadPoseResNet = saved
    return undo


def record(torch, seen: dict, timed: bool):
    """Watch the experiment's fused iterations and evaluations. Untimed:
    every iteration's losses (``pretrain``: pretrain and control; ``da``)
    and the state dicts of the last two models evaluated (the DA model and
    its EMA twin), on the host. Timed (12b): ms per DA iteration over the
    calls after the first ``RANKS_WARM`` up to the last ``RANKS_SYNCED``,
    between two synchronizes; then each of those last calls between
    synchronizes, with every all-reduce and all-gather timed alone the same
    way. Returns the undo."""
    import torch.distributed as dist

    from dahpe_tpu_torch import train
    from dahpe_tpu_torch.experiments import adaptation

    seen.update(pretrain=[], da=[], evaluated=[])
    clock = {"calls": 0, "collective_s": 0.0, "collective_calls": 0, "synced_s": 0.0}
    saved = train.make_fused_pretrain_iteration, train.make_fused_da_iteration
    real_eval = adaptation._eval_target
    collectives = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def synced(fn, counter):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            clock[counter + "_s"] += time.perf_counter() - t
            if counter == "collective":
                clock["collective_calls"] += 1
            return out
        return call

    def pretrain(*a, **kw):
        call = saved[0](*a, **kw)

        def run(*args):
            out = call(*args)
            if not timed:
                seen["pretrain"].append(float(out[1]["loss_s"]))
            return out
        return run

    def da(*a, **kw):
        call = saved[1](*a, **kw)
        last = synced(call, "synced")

        def run(*args):
            i = clock["calls"]
            clock["calls"] += 1
            if not timed:
                out = call(*args)
                seen["da"].append({k: float(out[1][k]) for k in DA_LOSSES})
                return out
            if i == RANKS_WARM:
                torch.cuda.synchronize()
                clock["t0"] = time.perf_counter()
            if i < RANKS_TIMED_ITERS - RANKS_SYNCED:
                return call(*args)
            if i == RANKS_TIMED_ITERS - RANKS_SYNCED:
                torch.cuda.synchronize()
                seen["ms_per_da_iter"] = ((time.perf_counter() - clock["t0"]) * 1e3
                                          / (i - RANKS_WARM))
                for name, fn in collectives.items():
                    setattr(dist, name, synced(fn, "collective"))
            out = last(*args)
            if i == RANKS_TIMED_ITERS - 1:
                restore_collectives()
                seen.update(synchronized_da_iter_ms=clock["synced_s"] * 1e3 / RANKS_SYNCED,
                            collective_calls_per_iter=clock["collective_calls"] / RANKS_SYNCED,
                            collective_ms_per_iter=clock["collective_s"] * 1e3 / RANKS_SYNCED,
                            collective_share=clock["collective_s"] / clock["synced_s"])
            return out
        return run

    def evaluated(model, *a, **kw):
        if not timed:
            seen["evaluated"] = seen["evaluated"][-1:] + [
                {k: v.detach().cpu() for k, v in model.state_dict().items()}]
        return real_eval(model, *a, **kw)

    def restore_collectives():
        for name, fn in collectives.items():
            setattr(dist, name, fn)

    train.make_fused_pretrain_iteration, train.make_fused_da_iteration = pretrain, da
    adaptation._eval_target = evaluated

    def undo():
        train.make_fused_pretrain_iteration, train.make_fused_da_iteration = saved
        adaptation._eval_target = real_eval
        restore_collectives()
    return undo


def experiment_run(torch, iters: int, *, draws: int | None = None, timed: bool = False,
                   float64: bool = False, deterministic: bool = False) -> dict:
    """The adaptation experiment at the acceptance configuration, ``iters``
    + ``iters`` + ``iters`` iterations, as this process's rank (or alone):
    on the global draws of a ``draws``-rank job, in float64, with cuDNN
    deterministic, as asked. Returns its result, the path kernels' launches
    in the run, its seconds and what :func:`record` saw."""
    from dahpe_tpu_torch import parallel
    from dahpe_tpu_torch.experiments import adaptation
    from dahpe_tpu_torch.ops import gaussian, pseudo_label, shear

    kernels = Kernels(gaussian, pseudo_label, shear)
    seen = {}
    undo = [record(torch, seen, timed)]
    if draws:
        undo.append(global_draws(torch, draws))
    if float64:
        undo.append(float64_models(torch))
    default = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    before = kernels.read()
    t0 = time.perf_counter()
    try:
        result = adaptation.run_adaptation_experiment(
            pre_iters=iters, da_iters=iters, n_devices=parallel.world_size(),
            device=CLI_DEVICE, **ACCEPTANCE)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = default
        for fn in reversed(undo):
            fn()
    return {"result": result, "seconds": time.perf_counter() - t0,
            "launches": {k: v - before[k] for k, v in kernels.read().items()}, **seen}


def experiment_launches(iters: int) -> dict:
    """The path kernels' launches of one experiment run of ``iters`` +
    ``iters`` + ``iters`` iterations: a pretrain or control step 1 / 0 / 1
    (render_gaussian / pseudo_labels / rotate3_fused), a DA iteration 7 / 3
    / 2, an eval batch 1 / 0 / 0, over five evaluations of the whole
    validation split (pretrain on source and target, control, the DA
    curve's one point, the EMA twin)."""
    evals = 5 * -(-ACCEPTANCE["n_val"] // ACCEPTANCE["batch"])
    return dict(NO_LAUNCHES, render_gaussian=2 * iters + 7 * iters + evals,
                pseudo_labels=3 * iters, rotate3_fused=4 * iters)


def adaptation_rank(frames: str) -> dict:
    """Phase 12, one rank (spawned by ``parallel.run_ranks``): 12a's run on
    the global draws, cuDNN deterministic, whose evaluated states must be
    equal on every rank; then 12b's timed run. Rank 0 returns every rank's
    outputs and its evaluated states."""
    import torch
    import torch.distributed as dist

    from dahpe_tpu_torch import parallel

    undo = frame_memo(torch, frames)[1]
    try:
        parity = experiment_run(torch, RANKS_PARITY_ITERS, draws=parallel.world_size(),
                                deterministic=True)
        states = parity.pop("evaluated")
        parity["replicated_tensors"] = parallel.assert_replicated(
            [v for state in states for v in state.values()])
        timed = experiment_run(torch, RANKS_TIMED_ITERS, timed=True)
    finally:
        undo()
    everyone = [None] * parallel.world_size()
    dist.all_gather_object(everyone, {"parity": parity, "timed": timed})
    return {"ranks": everyone, "evaluated": states}


def state_gap(torch, got: list, base: list) -> dict:
    """The worst |Δ| of the DA and EMA states ``got`` against ``base``,
    parameters and BN statistics apart, and where; integer buffers must be
    equal."""
    worst, at = {"parameters": 0.0, "bn_statistics": 0.0}, {}
    for name, g, b in (("da", got[0], base[0]), ("ema", got[1], base[1])):
        for k, v in b.items():
            if not v.is_floating_point():
                if not torch.equal(g[k], v):
                    raise AssertionError(f"12a: {name} {k} {g[k]} vs {v}")
                continue
            kind = "bn_statistics" if k.endswith(("running_mean", "running_var")) else "parameters"
            diff = float((g[k].double() - v.double()).abs().max())
            if diff > worst[kind]:
                worst[kind], at[kind] = diff, (f"{name} {k}", float(v.abs().max()))
    return {"worst_abs": worst, "at_tensor_and_its_largest_abs": at}


def phase_adaptation_ranks(torch, smi, root, world: int = RANKS_WORLD, backend: str = "gloo"):
    """Phase 12: the adaptation experiment over ``world`` ranks sharing the
    card over gloo (with ``--cards``, one rank a card over NCCL), spawned
    by ``parallel.run_ranks``, at the acceptance configuration. (a) 2 + 2 +
    2 iterations on the global draws of the ranks against one process on
    the same draws, cuDNN deterministic: losses within rel 1e-4, the DA
    and EMA states within 10b's bounds (parameters ``DATA_PARALLEL_ATOL``,
    BN statistics ``BN_FLOOR_FACTOR`` times this run's float64 floor: the
    one process in float64 against float32), the five PCKs within
    ``RANKS_PCK_TOL``, one result and equal states on every rank, and each
    rank's launches those the iterations imply. (b) 50 + 50 + 50
    iterations at W = ``world`` and at W = 1: ms per DA iteration, the
    collectives' share, the launches per rank (reported, no bound: ranks
    sharing one card give no scaling figure). The frames are rendered once
    in this process (:func:`frame_memo`, over any memo already installed)
    and saved in ``root`` for the ranks; ``root`` is deleted after."""
    from dahpe_tpu_torch import parallel

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "frames.pt")
    frames, undo = frame_memo(torch)
    saved_backend = os.environ.get("DAHPE_DIST_BACKEND")
    try:
        want = experiment_run(torch, RANKS_PARITY_ITERS, draws=world, deterministic=True)
        torch.save(frames, path)  # the ranks' frames
        f64 = experiment_run(torch, RANKS_PARITY_ITERS, draws=world, deterministic=True,
                             float64=True)
        torch.cuda.empty_cache()
        os.environ["DAHPE_DIST_BACKEND"] = backend
        t_ranks = time.perf_counter()
        ranks = parallel.run_ranks(adaptation_rank, world, device=CLI_DEVICE,
                                   kwargs={"frames": path}, timeout=WORKER_TIMEOUT)
        ranks_s = time.perf_counter() - t_ranks
        alone = experiment_run(torch, RANKS_TIMED_ITERS, timed=True)
    finally:
        undo()
        if saved_backend is None:
            os.environ.pop("DAHPE_DIST_BACKEND", None)
        else:
            os.environ["DAHPE_DIST_BACKEND"] = saved_backend
        shutil.rmtree(root, ignore_errors=True)

    for run in (want, f64):
        if run["launches"] != experiment_launches(RANKS_PARITY_ITERS):
            raise AssertionError(f"12a: one process launched {run['launches']}, expected "
                                 f"{experiment_launches(RANKS_PARITY_ITERS)}")
    rounding = state_gap(torch, want["evaluated"], f64["evaluated"])
    bounds = {"parameters": DATA_PARALLEL_ATOL,
              "bn_statistics": BN_FLOOR_FACTOR * rounding["worst_abs"]["bn_statistics"]}
    gap = state_gap(torch, ranks["evaluated"], want["evaluated"])
    ranks_vs_f64 = state_gap(torch, ranks["evaluated"], f64["evaluated"])
    if not all(gap["worst_abs"][kind] <= bound for kind, bound in bounds.items()):
        raise AssertionError(f"12a: {world} ranks vs one process {gap} against {bounds}; "
                             f"float64 floor {rounding}; ranks vs float64 {ranks_vs_f64}")
    results = [r["parity"]["result"] for r in ranks["ranks"]]
    for r, res in enumerate(ranks["ranks"]):
        parity, timed = res["parity"], res["timed"]
        if parity["result"] != results[0]:
            raise AssertionError(f"12a: rank {r} result {parity['result']} vs {results[0]}")
        losses = [(x, y) for x, y in zip(parity["pretrain"], want["pretrain"], strict=True)]
        losses += [(x[k], y[k]) for x, y in zip(parity["da"], want["da"], strict=True)
                   for k in DA_LOSSES]
        rel = max(abs(x - y) / abs(y) for x, y in losses)
        if not rel <= 1e-4:
            raise AssertionError(f"12a: rank {r} losses {parity['pretrain']} {parity['da']} vs "
                                 f"one process {want['pretrain']} {want['da']}")
        for run, iters in ((parity, RANKS_PARITY_ITERS), (timed, RANKS_TIMED_ITERS)):
            if run["launches"] != experiment_launches(iters):
                raise AssertionError(f"12: rank {r} launched {run['launches']} in {iters}-"
                                     f"iteration runs, expected {experiment_launches(iters)}")
    pck = {k: abs(results[0][k] - want["result"][k]) for k in PCK_KEYS}
    if not max(pck.values()) <= RANKS_PCK_TOL:
        raise AssertionError(f"12a: PCKs {results[0]} vs one process {want['result']}")
    where = ("sharing the card over gloo" if backend == "gloo"
             else f"one a card over {backend}")
    line(f"phase 12a adaptation experiment {world} ranks {where} vs one process, resnet18 "
         f"128²/32², batch 32, {RANKS_PARITY_ITERS}+{RANKS_PARITY_ITERS}+{RANKS_PARITY_ITERS} "
         "iterations", {
             "card": smi, "cudnn_deterministic": True, "vs_one_process": gap,
             "one_process_float32_vs_float64": rounding, "ranks_vs_float64": ranks_vs_f64,
             "bounds": bounds,
             "bn_gap_over_floor": gap["worst_abs"]["bn_statistics"]
             / rounding["worst_abs"]["bn_statistics"],
             "max_loss_rel": rel, "pck_abs_diff": pck, "pck_tolerance": RANKS_PCK_TOL,
             "result_rank_0": results[0], "result_one_process": want["result"],
             "replicated_tensors": ranks["ranks"][0]["parity"]["replicated_tensors"],
             "launches_per_rank": [res["parity"]["launches"] for res in ranks["ranks"]],
             "seconds_one_process": want["seconds"], "seconds_float64": f64["seconds"]})
    keys = ("ms_per_da_iter", "synchronized_da_iter_ms", "collective_calls_per_iter",
            "collective_ms_per_iter", "collective_share", "seconds", "launches")
    line(f"phase 12b adaptation experiment {world} ranks {where} and 1 process, resnet18 "
         f"128²/32², batch 32, {RANKS_TIMED_ITERS}+{RANKS_TIMED_ITERS}+{RANKS_TIMED_ITERS} "
         "iterations", {
             "card": smi, "seconds": time.perf_counter() - t0, "ranks_launch_s": ranks_s,
             f"world_{world}": [{k: res["timed"][k] for k in keys} for res in ranks["ranks"]],
             "world_1": {k: alone[k] for k in keys}})
    return [res[run]["launches"] for res in ranks["ranks"] for run in ("parity", "timed")] + \
        [run["launches"] for run in (want, f64, alone)]


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
    phase3 = phase_serving(torch, evaluate, models, model, smi)
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
    kernels.reset()  # main path 2 at heatmap 96
    for name, count in phase_training_96(torch, models, train, data, kernels, smi).items():
        launches[name] += count
    torch.cuda.empty_cache()
    cli_launches, cli_best = phase_cli(torch, kernels, smi, bare_ms, checkpoint)
    for name, count in cli_launches.items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the CLI path")
        launches[name] += count
    torch.cuda.empty_cache()
    artifact_launches = phase_artifacts(torch, models, kernels, smi, phase3, cli_best)
    if artifact_launches["render_gaussian"] == 0:
        raise AssertionError("render_gaussian kernel never launched on the artifact's eval path")
    for name, count in artifact_launches.items():
        launches[name] += count
    torch.cuda.empty_cache()
    # phase 7's servers set cuDNN deterministic for the process; training
    # runs at cuDNN's default, as phases 5 and 6 do
    torch.backends.cudnn.deterministic = False
    kernels.reset()  # main path 5: the DA and pretrain iterations replayed from CUDA graphs
    phase8a = phase_graphs(torch, models, train, data, smi)
    for name, count in kernels.read().items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the graphed paths")
        launches[name] += count
    torch.cuda.empty_cache()
    kernels.reset()  # main path 6: the training CLI with --steps-per-call
    for name, count in phase_cli_chunked(torch, kernels, smi, cli_best).items():
        launches[name] += count
    torch.cuda.empty_cache()
    # phases 8c, 9e and 12 run the experiment on the same domains: each
    # frame is rendered once
    undo_frames = frame_memo(torch)[1]
    kernels.reset()  # main path 7: the adaptation experiment
    phase_adaptation(torch, smi)
    for name, count in kernels.read().items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the adaptation path")
        launches[name] += count
    torch.cuda.empty_cache()

    # phase 9: the bfloat16 compute dtype on each path
    t9 = time.perf_counter()
    kernels.reset()  # main path 8: the bf16 DA and pretrain iterations
    phase_bf16_training(torch, models, train, data, kernels, smi)
    for name, count in kernels.read().items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the bf16 training path")
        launches[name] += count
    torch.cuda.empty_cache()
    phase_bf16_serving(torch, models, evaluate, smi)  # no path kernel: frames in, no targets
    torch.cuda.empty_cache()
    kernels.reset()  # main path 9: the training CLI with --bf16 --steps-per-call
    for name, count in phase_cli_chunked(torch, kernels, smi, cli_best, bf16=True).items():
        launches[name] += count
    torch.cuda.empty_cache()
    kernels.reset()  # main path 10: the adaptation experiment in bf16
    phase_adaptation(torch, smi, bf16=True)
    for name, count in kernels.read().items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the bf16 adaptation path")
        launches[name] += count
    line("phase 9 bf16", {"card": smi, "phase_9_s": time.perf_counter() - t9})
    torch.cuda.empty_cache()

    # phase 10: data parallelism
    t10 = time.perf_counter()
    kernels.reset()  # main path 11: the data-parallel DA iteration, world 1 over NCCL
    stores = phase_parallel_world1(torch, models, train, data, smi, bare_ms, phase8a)
    for name, count in kernels.read().items():
        if name in PATH_KERNELS and count == 0:
            raise AssertionError(f"{name} kernel never launched on the data-parallel path")
        launches[name] += count
    torch.cuda.empty_cache()
    root10 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_parallel")
    # main paths 12 and 13: two ranks' iteration and the CLI, each rank a
    # process of its own that counts its launches from 0
    rank_launches = phase_parallel_two_ranks(torch, models, train, smi, stores, root10,
                                             floor_worlds=(4,))
    del stores
    torch.cuda.empty_cache()
    rank_launches += phase_parallel_cli(torch, smi, root10)
    for counts in rank_launches:
        for name, count in counts.items():
            launches[name] += count
    # no path kernel: frames in, no targets
    phase_serve_mesh(torch, smi, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                              "build", "chip_smoke_serving"))
    shutil.rmtree(root10, ignore_errors=True)
    line("phase 10 data parallel", {"card": smi, "phase_10_s": time.perf_counter() - t10})
    torch.cuda.empty_cache()

    # phase 11: the host-warp path, the producer's stages, the drill, RegDA
    t11 = time.perf_counter()
    # main path 14: cli.train --host-warp
    for name, count in phase_host_warp(torch, kernels, smi).items():
        launches[name] += count
    torch.cuda.empty_cache()
    for name, count in phase_perf_audit(torch, kernels, smi).items():  # main path 15
        launches[name] += count
    torch.cuda.empty_cache()
    # main path 16: the drill's two CLI processes, which count their own
    for name, count in phase_drill(torch, smi).items():
        launches[name] += count
    phase_regda(torch, models, smi)  # no path kernel: frames in, heatmaps out
    line("phase 11 host warp, producer stages, drill, RegDA",
         {"card": smi, "phase_11_s": time.perf_counter() - t11})
    torch.cuda.empty_cache()

    # phase 12: the adaptation experiment over two ranks; main path 17: the
    # ranks count their own launches, the runs in this process theirs
    t12 = time.perf_counter()
    for counts in phase_adaptation_ranks(torch, smi, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ranks")):
        for name, count in counts.items():
            launches[name] += count
    undo_frames()
    line("phase 12 adaptation over ranks", {"card": smi, "phase_12_s": time.perf_counter() - t12})

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


def main_cards() -> int:
    """``chip_smoke.py --cards``, on a machine with several cards: the
    phases that need every card. ``cli.serve --mesh`` over every card
    against one card on a freshly exported float artifact (uint8 ingest,
    batch-polymorphic), then phase 10b with one rank a card over NCCL
    against world 1, then phase 12 with one rank a card over NCCL at the
    experiment's rank count for every card. The kernels are built as in phase 1; the last line is
    the one of a full run."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs at least two CUDA devices", file=sys.stderr)
        return 2
    from dahpe_tpu_torch import data, models, serving, train
    from dahpe_tpu_torch.experiments.adaptation import rank_count
    from dahpe_tpu_torch.ops import _build

    smi = phase_device(torch, _build)
    world = torch.cuda.device_count()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_cards")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    model = build_model(torch, models).to(CLI_DEVICE)
    artifact = os.path.join(root, "float.pt2")
    serving.save_predict(artifact, model, image_size=IMAGE, heatmap_size=HEATMAP,
                         uint8_input=True, device=CLI_DEVICE)
    serving.save_variables_npz(artifact + ".weights.npz", model)
    del model
    torch.cuda.empty_cache()
    phase_serve_mesh(torch, smi, root)
    stores = [data.DeviceDataStore(SyntheticSplit(256, RAW, seed=seed), device=CLI_DEVICE,
                                   raw_size=RAW, verbose=False) for seed in (2, 3)]
    phase_parallel_two_ranks(torch, models, train, smi, stores, root, world, "nccl")
    del stores
    torch.cuda.empty_cache()
    phase_adaptation_ranks(torch, smi, os.path.join(here, "build", "chip_smoke_ranks"),
                           rank_count(ACCEPTANCE["batch"], None, world), "nccl")
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:  # one rank of phase 10 (run_workers)
        sys.exit(worker_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(main_cards())
    if sys.argv[1:2] == ["--cli-train"]:  # phase 11c's training CLI (cli_train_main)
        sys.exit(cli_train_main(sys.argv[2:]))
    sys.exit(main())
