"""Fused pseudo-labels (GT + ground-false): the CUDA kernel and its plain twin.

Port of the TPU kernel ``dahpe_tpu/ops/pallas/pseudo_label.py:pseudo_labels_pallas``.
The kernel lives in ``dahpe_tpu_torch/csrc/pseudo_label.cu`` (its header says
what bounds it and how its design answers that); this module builds, binds
and launches it, and holds :func:`pseudo_labels_plain`, the same function in
plain PyTorch built from the ``core.heatmap`` label functions.

:func:`pseudo_labels` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from dahpe_tpu_torch.core import heatmap
from dahpe_tpu_torch.ops import _build
from dahpe_tpu_torch.ops.gaussian import _two_sigma_sq, render_gaussian_plain

LIB_NAME = "pseudo_label"
SOURCES = ["pseudo_label.cu"]
GF_KINDS = {"union_minus": 0, "inverse": 1, "union_others": 2}
CLUSTER_BLOCKS = 8  # blocks of one batch element and joint group (csrc/pseudo_label.cu)
SMALL_MAP = 8192  # pixels of the largest map the 8-block kernel takes (90²)
GROUP_JOINTS = 64  # joints a block keeps at most
TABLE_PIXELS = 8192  # the general kernel's sum table (32 KB); longer ranges take tiles
THREADS = 512
# 227 KB a block may use, less each kernel's static arrays (peaks, maxima, Gaussians)
SMALL_SHARED_LIMIT = 232448 - 2048
SHARED_LIMIT = 232448 - 4096

# kernel launches made by pseudo_labels_cuda since the last reset
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME, SOURCES)
    fn = lib.pseudo_labels_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def launch_geometry(size: int, joints: int) -> dict:
    """How ``csrc/pseudo_label.cu`` covers one ``size x size x joints`` map.

    Per batch element, a cluster of ``blocks`` (8) blocks for each of
    ``groups`` groups of at most ``GROUP_JOINTS`` joints (``K // groups``
    each, the first ``K % groups`` one more, in order). Block ``r`` owns
    pixels ``[r * pixels, min((r + 1) * pixels, size²))`` with its group's
    joints, ``threads`` threads (a multiple of the largest group, so each
    thread keeps one joint), a sum table of ``tile`` pixels (a longer range
    walks it in tiles) and ``shared_bytes`` of dynamic shared memory: the
    table and, when ``staged``, the range's GF. Staging needs the GF beside
    the table within the 227 KB a block may use; where it does not fit,
    ``staged`` is False and the kernel recomputes GF in a second pass.

    The maps of at most ``SMALL_MAP`` pixels and ``GROUP_JOINTS`` joints
    (every build of the training path) take the 8-block kernel (``wide``
    False: one group, the whole range in the table); the others take the
    general kernel."""
    wide = size * size > SMALL_MAP or joints > GROUP_JOINTS
    pixels = -(-size * size // CLUSTER_BLOCKS)
    groups = -(-joints // GROUP_JOINTS)
    group_joints = -(-joints // groups)
    tile = max(1, min(pixels, TABLE_PIXELS))
    table = 4 * (-(-tile // 4) * 4)  # padded so the staged run is 16-byte aligned
    limit = SHARED_LIMIT if wide else SMALL_SHARED_LIMIT
    staged = table + 4 * pixels * group_joints <= limit
    return {"wide": wide, "blocks": CLUSTER_BLOCKS, "pixels": pixels, "groups": groups,
            "group_joints": group_joints, "threads": (THREADS // group_joints) * group_joints,
            "tile": tile, "staged": staged,
            "shared_bytes": table + (4 * pixels * group_joints if staged else 0)}


def pseudo_labels_plain(
    peaks: torch.Tensor,
    fused_target: torch.Tensor | None = None,
    *,
    out_size: int,
    sigma: float = 2.0,
    reach: int = 6,
    gf_kind: str = "union_minus",
    normalize: bool = True,
    with_gt: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version: ``peaks (B, K, 2)`` int ``(x, y)`` in
    ``out_size`` units, optional ``fused_target (B, S, S, K)`` →
    ``(gt, gf)``, each ``(B, S, S, K)`` float32; ``(None, gf)`` when
    ``with_gt`` is False."""
    if gf_kind not in GF_KINDS:
        raise ValueError(f"unknown gf_kind {gf_kind!r}; choices: {sorted(GF_KINDS)}")
    valid = torch.ones(peaks.shape[:2], dtype=torch.float32, device=peaks.device)
    gt = render_gaussian_plain(peaks, valid, height=out_size, width=out_size,
                               sigma=sigma, reach=reach)
    gf = {"union_minus": heatmap.gf_union_minus, "inverse": heatmap.gf_inverse,
          "union_others": heatmap.gf_union_others}[gf_kind](gt)
    if fused_target is not None:
        gf = torch.clamp(gf + fused_target - gt * 100.0, 0.0, 1.0)
    if normalize:
        gf = heatmap.fuse_and_normalize_gf(gf, gt, None)
    return (gt if with_gt else None), gf


def pseudo_labels_cuda(
    peaks: torch.Tensor,
    fused_target: torch.Tensor | None = None,
    *,
    out_size: int,
    sigma: float = 2.0,
    reach: int = 6,
    gf_kind: str = "union_minus",
    normalize: bool = True,
    with_gt: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`pseudo_labels_plain`. ``peaks`` must be contiguous int32 and
    ``fused_target`` contiguous float32, on one CUDA device. Without
    ``with_gt`` the kernel writes GF alone."""
    global launches
    if not peaks.is_cuda:
        raise ValueError("pseudo_labels_cuda: peaks must be on a CUDA device")
    if peaks.dtype != torch.int32 or peaks.dim() != 3 or peaks.shape[-1] != 2:
        raise ValueError(
            f"pseudo_labels_cuda: need int32 peaks (B, K, 2), got "
            f"{peaks.dtype} {tuple(peaks.shape)}"
        )
    if gf_kind not in GF_KINDS:
        raise ValueError(f"unknown gf_kind {gf_kind!r}; choices: {sorted(GF_KINDS)}")
    b, k, _ = peaks.shape
    shape = (b, out_size, out_size, k)
    if fused_target is not None:
        if fused_target.device != peaks.device or fused_target.dtype != torch.float32:
            raise ValueError("pseudo_labels_cuda: fused_target must be float32 beside peaks")
        if tuple(fused_target.shape) != shape:
            raise ValueError(
                f"pseudo_labels_cuda: fused_target {tuple(fused_target.shape)}, need {shape}"
            )
        if not fused_target.is_contiguous():
            raise ValueError("pseudo_labels_cuda: fused_target must be contiguous")
    if not peaks.is_contiguous():
        raise ValueError("pseudo_labels_cuda: peaks must be contiguous")
    gf = torch.empty(shape, dtype=torch.float32, device=peaks.device)
    gt = torch.empty_like(gf) if with_gt else None
    if gf.numel() == 0:
        return gt, gf
    geometry = launch_geometry(int(out_size), k)
    lib = _lib()
    with torch.cuda.device(peaks.device):
        stream = torch.cuda.current_stream(peaks.device).cuda_stream
        err = lib.pseudo_labels_f32(
            peaks.data_ptr(), None if fused_target is None else fused_target.data_ptr(),
            None if gt is None else gt.data_ptr(), gf.data_ptr(), b, int(out_size), k,
            _two_sigma_sq(sigma), int(reach), GF_KINDS[gf_kind], int(bool(normalize)),
            int(geometry["wide"]), geometry["groups"], geometry["threads"],
            geometry["tile"], int(geometry["staged"]), geometry["shared_bytes"], stream,
        )
    if err != 0:
        raise RuntimeError(f"pseudo_labels kernel launch failed: cudaError {err} "
                           f"(B={b}, S={out_size}, K={k}, {geometry})")
    launches += 1
    return gt, gf


def pseudo_labels(
    peaks: torch.Tensor,
    fused_target: torch.Tensor | None = None,
    *,
    out_size: int,
    sigma: float = 2.0,
    reach: int = 6,
    gf_kind: str = "union_minus",
    normalize: bool = True,
    with_gt: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    ``(None, gf)`` when ``with_gt`` is False."""
    kw = dict(out_size=out_size, sigma=sigma, reach=reach, gf_kind=gf_kind,
              normalize=normalize, with_gt=with_gt)
    if peaks.device.type == "cuda":
        fused = None if fused_target is None else fused_target.to(torch.float32).contiguous()
        return pseudo_labels_cuda(peaks.to(torch.int32).contiguous(), fused, **kw)
    if peaks.device.type == "cpu":
        return pseudo_labels_plain(peaks, fused_target, **kw)
    raise ValueError(f"pseudo_labels: no kernel for device {peaks.device}")
