"""The benchmark's fixed arithmetic: the card's peaks, the kernel kinds of a
trace, the model's FLOPs and the path kernels' least times, and the
reduction of a profiler trace to busy time, kinds and idle gaps.

The FLOPs are counted on :mod:`portbench.reference.model` (on the meta
device, nothing computed), never on the program's model, so a change to the
program cannot move them. Peaks: one H100 SXM (NVIDIA's data sheet, dense).
"""

from __future__ import annotations

import torch

BF16_OPS_PER_S = 989e12  # tensor cores, dense
FP32_OPS_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

PORT_KERNELS = ("render_gaussian_kernel", "pseudo_labels", "rotate3_fused_kernel",
                "rotate3_u16_kernel")
# the first kind whose marker a kernel's printed name holds: collectives,
# the port's own kernels, cuDNN's layout conversions, batch norm (ATen's
# kernels, and cuDNN's "batchnorm_*" that float32 channels-last runs),
# convolutions and GEMMs, the multi-tensor (foreach) passes; "other" is the
# remaining elementwise and reduction work
KERNEL_KINDS = (("collective", ("nccl",)), ("port", PORT_KERNELS),
                ("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("batch_norm", ("batch_norm", "batchnorm", "bn_")),
                ("convolution", ("xmma", "cutlass", "cudnn", "conv", "gemm", "dgrad", "wgrad")),
                ("foreach", ("multi_tensor_apply",)))


def peak_ops(dtype: str) -> float:
    return {"bfloat16": BF16_OPS_PER_S, "float32": FP32_OPS_PER_S}[dtype]


def kind_of(name: str) -> str:
    return next((k for k, marks in KERNEL_KINDS if any(m in name for m in marks)), "other")


def flops_by_part(config: dict) -> dict[str, int]:
    """Forward FLOPs (2 per multiply-add) of one frame through the model's
    ``features`` (backbone + deconvolutions), main ``head`` and three
    ``adv`` heads, from every convolution's shapes. Elementwise work is left
    out."""
    from portbench.reference.model import PoseModel

    model = PoseModel(config["layers"], config["num_keypoints"], config["feature_dim"])
    model = model.to("meta").eval()
    macs = []

    def count(mod, inputs, out):
        taps = (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            taps = (mod.out_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
            macs.append(inputs[0].numel() * taps)
        else:
            macs.append(out.numel() * taps)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    size = config["image_size"]
    parts = {}
    with torch.no_grad():
        f = model.features(torch.empty(1, size, size, 3, device="meta"))
        parts["features"], macs[:] = 2 * sum(macs), []
        model.main_head(f)
        parts["head"], macs[:] = 2 * sum(macs), []
        model.adv_heads(f, torch.zeros((), device="meta"))
        parts["adv"] = 2 * sum(macs)
    for h in hooks:
        h.remove()
    return parts


def flops_per_frame(config: dict) -> int:
    """One frame through the serving path: features, then the main head."""
    p = flops_by_part(config)
    return p["features"] + p["head"]


def flops_per_da_iteration(config: dict, batch: int) -> int:
    """One DA iteration with shared target features, a backward counted as
    twice its forward: Step A runs the whole model forward and back on the
    source batch; the target batch runs the features forward and back once,
    the main head forward once and the adversarial heads forward and back
    twice (Steps B and C)."""
    p = flops_by_part(config)
    source = 3 * (p["features"] + p["head"] + p["adv"])
    target = 3 * p["features"] + p["head"] + 2 * 3 * p["adv"]
    return batch * (source + target)


def labels_bound_ms(b, size, joints, gf_kind, fused, normalize, with_gt=False):
    """Least time of one pseudo-label build: the peaks (and the fused
    target) read once, GF (and GT) written once, against the float32 work
    that does not depend on the data (2 window compares and ~6 operations
    for GF per element, 4 more to fuse, 2 to normalize, the union's K adds
    per pixel). Returns ``(ms, "bytes" | "operations")``."""
    elements = b * size * size * joints
    in_bytes = b * joints * 8 + (elements * 4 if fused else 0)
    bytes_ms = (in_bytes + (2 if with_gt else 1) * elements * 4) / HBM_BYTES_PER_S * 1e3
    ops = elements * (2 + 6 + (4 if fused else 0) + (2 if normalize else 0))
    if gf_kind != "inverse":
        ops += b * size * size * joints
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def da_labels_bound_ms(b, heatmap, joints) -> float:
    """The three label builds of Step B of one DA iteration, each GF alone:
    union-minus fused and normalized at the heatmap's size, inverse fused and
    normalized at half, inverse plain at a quarter."""
    return sum(labels_bound_ms(b, size, joints, kind, fused, norm)[0] for size, kind, fused, norm in
               ((heatmap, "union_minus", True, True), (heatmap // 2, "inverse", True, True),
                (heatmap // 4, "inverse", False, False)))


def rotation_bound_ms(b, size, channels, in_bytes=1):
    """Least time of one rotation launch: the input read once and the
    float32 output written once, against its work at the float32 rate (per
    pixel 7 shear lines of 7 operations, per channel 7 blends of 5 and the
    1/256 scale). Returns ``(ms, "bytes" | "operations")``."""
    pixels = b * size * size
    bytes_ms = (pixels * channels * (in_bytes + 4) + b * 12) / HBM_BYTES_PER_S * 1e3
    ops_ms = pixels * (7 * 7 + channels * (7 * 5 + 1)) / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def reduce_trace(events, spans, begin, finish) -> dict:
    """A profiled slice ``[begin, finish]`` (µs) reduced: ``events`` the
    device's ``(name, start_us, end_us)`` inside it, ``spans`` the host's
    ``(name, start_us, end_us)`` annotations. Returns the busy seconds (union
    of device intervals), device seconds by kind and by kernel name, and the
    idle gaps (between device work and at the slice's ends), each named by
    the host annotation that spans its middle."""
    iv = sorted((a, b) for _, a, b in events)
    busy, merged = 0.0, []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    kinds, names = {}, {}
    for name, a, b in events:
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + (b - a) / 1e6
        names[name] = names.get(name, 0.0) + (b - a) / 1e6
    gaps = []
    edges = [[begin, begin]] + merged + [[finish, finish]]
    for (_, end), (start, _) in zip(edges, edges[1:]):
        if start <= end:
            continue
        mid = (end + start) / 2
        host = [s for s in spans if s[1] <= mid <= s[2]]
        label = min(host, key=lambda s: s[2] - s[1])[0] if host else "host"
        gaps.append((label, (start - end) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy / 1e6, "kinds_s": kinds, "names_s": names, "gaps": gaps}
