"""ctypes bindings of the native host-side data-loader core.

Port of ``dahpe_tpu/utils/native.py`` over the port's own copy of the C++
source, ``dahpe_tpu_torch/native/dahpe_native.cpp``. The library is built
at first use with ``g++`` and the flags the JAX package builds its copy
with, so on one machine both packages' libraries compute the same thing.
It lands in ``build/native/libdahpe_native-<hash>.so``, the hash covering
the source and the flags: an edited source builds a new library and a
stale one is never loaded. The compiler writes a temporary name that ``os.replace``
moves into place, so concurrent processes never see a half-written file.

There is no fallback: a missing ``g++`` or a failed build raises with the
compiler's output (the JAX package drops to numpy instead). The numpy
versions of the entry points stay here as ``*_plain``, for the tests.
ctypes releases the GIL for each call, so the threaded ``BatchLoader``
scales across cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "dahpe_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
GXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # library path -> the bound library


def library_path() -> str:
    """``build/native/libdahpe_native-<sha256 of flags and source>.so``."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdahpe_native-{h.hexdigest()[:16]}.so")


def build() -> tuple[str, dict]:
    """Compile the library unless it exists; returns its path and a record
    of the build (whether it ran, its seconds). Raises with the compiler's
    output when ``g++`` is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path, {"built": False, "seconds": 0.0}
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host warp (--host-warp) "
                           "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the native host warp:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, {"built": True, "seconds": seconds}


def load() -> ctypes.CDLL:
    """The library, built at first use and loaded once a process."""
    with _lock:
        path = library_path()
        if path not in _loaded:
            _loaded[path] = _bind(ctypes.CDLL(build()[0]))
        return _loaded[path]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i, f = ctypes.c_int, ctypes.c_float
    lib.affine_warp_u8_f32.argtypes = [u8p, i, i, f32p, f32p, f32p, i, i, f32p, f32p, i]
    lib.resize_norm_u8_f32.argtypes = [u8p, i, i, f32p, i, f32p, f32p]
    lib.render_gaussian_f32.argtypes = [i32p, f32p, i, i, i, f, i, f32p]
    lib.calc_dists_f32.argtypes = [f32p, f32p, f32p, i, i, f32p]
    lib.augment_u8_f32.argtypes = [u8p, i, i, f32p, f32p, i32p, f32p, i, f, f32p, i, f32p,
                                   f32p, f32p]
    for fn in (lib.affine_warp_u8_f32, lib.resize_norm_u8_f32, lib.render_gaussian_f32,
               lib.calc_dists_f32, lib.augment_u8_f32):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def affine_warp(src: np.ndarray, mat: np.ndarray, off: np.ndarray, out_size: tuple[int, int],
                mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD,
                border_mode: int = 0) -> np.ndarray:
    """Fused bilinear warp + normalize: ``src (H, W, 3)`` uint8 → ``(out_h,
    out_w, 3)`` float32. ``mat (2, 2)`` and ``off (2,)`` map output pixel
    centres to source pixel coordinates ``(x, y)``; ``border_mode`` 0 reads
    zeros outside the source, 1 clamps to its edge."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    mat, off, mean, std = _f32(mat), _f32(off), _f32(mean), _f32(std)
    h, w, _ = src.shape
    out_h, out_w = out_size
    dst = np.empty((out_h, out_w, 3), np.float32)
    lib.affine_warp_u8_f32(_ptr(src, ctypes.c_uint8), h, w, _ptr(mat), _ptr(off), _ptr(dst),
                           out_h, out_w, _ptr(mean), _ptr(std), border_mode)
    return dst


def affine_warp_plain(src: np.ndarray, mat: np.ndarray, off: np.ndarray,
                      out_size: tuple[int, int], mean: np.ndarray = IMAGENET_MEAN,
                      std: np.ndarray = IMAGENET_STD, border_mode: int = 0) -> np.ndarray:
    """numpy version of :func:`affine_warp` (the JAX package's fallback)."""
    mat, off = _f32(mat), _f32(off)
    h, w, _ = src.shape
    out_h, out_w = out_size
    ys, xs = np.meshgrid(np.arange(out_h, dtype=np.float32) + 0.5,
                         np.arange(out_w, dtype=np.float32) + 0.5, indexing="ij")
    pts = np.stack([xs, ys], -1) @ mat.T + off - 0.5
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    dx, dy = (x - x0)[..., None], (y - y0)[..., None]
    out = np.zeros((out_h, out_w, 3), np.float32)
    for oy, ox, wgt in ((0, 0, (1 - dx) * (1 - dy)), (0, 1, dx * (1 - dy)),
                        (1, 0, (1 - dx) * dy), (1, 1, dx * dy)):
        yy, xx = y0 + oy, x0 + ox
        if border_mode == 1:
            valid = np.ones(xx.shape, bool)
        else:
            valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32)
        out += wgt * vals * valid[..., None]
    return ((out / 255.0) - mean) / std


def resize_norm(src: np.ndarray, out: int) -> np.ndarray:
    """Square bilinear resize (edge-clamped) + ImageNet normalize: the eval
    path's ``resize_norm_u8_f32``."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    h, w, _ = src.shape
    dst = np.empty((out, out, 3), np.float32)
    lib.resize_norm_u8_f32(_ptr(src, ctypes.c_uint8), h, w, _ptr(dst), out,
                           _ptr(IMAGENET_MEAN), _ptr(IMAGENET_STD))
    return dst


def resize_norm_plain(src: np.ndarray, out: int) -> np.ndarray:
    """numpy version of :func:`resize_norm`."""
    h, w, _ = src.shape
    mat = np.asarray([[w / out, 0.0], [0.0, h / out]], np.float32)
    return affine_warp_plain(src, mat, np.zeros(2, np.float32), (out, out), border_mode=1)


def fused_augment(src: np.ndarray, mat: np.ndarray, off: np.ndarray, out_size: int,
                  jitter_ops: np.ndarray, jitter_factors: np.ndarray, blur_sigma: float,
                  mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """The fused training augmentation of one image: warp (zeros outside)
    → colour jitter (``jitter_ops[i]`` with ``jitter_factors[i]``, in order;
    0 brightness, 1 contrast, 2 saturation) → 5-tap Gaussian blur of
    ``blur_sigma`` (off at or below 0.01) → normalize. The numpy version is
    :func:`dahpe_tpu_torch.data.host_warp.augment_plain`."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    h, w, _ = src.shape
    mat, off, mean, std = _f32(mat), _f32(off), _f32(mean), _f32(std)
    ops = np.ascontiguousarray(jitter_ops, np.int32)
    factors = _f32(jitter_factors)
    dst = np.empty((out_size, out_size, 3), np.float32)
    tmp = np.empty((out_size, out_size, 3), np.float32)
    lib.augment_u8_f32(_ptr(src, ctypes.c_uint8), h, w, _ptr(mat), _ptr(off),
                       _ptr(ops, ctypes.c_int32), _ptr(factors), int(len(ops)),
                       ctypes.c_float(blur_sigma), _ptr(dst), out_size, _ptr(mean), _ptr(std),
                       _ptr(tmp))
    return dst


def render_gaussian(mu: np.ndarray, valid: np.ndarray, h: int, w: int, sigma: float = 2.0,
                    reach: int = 6) -> np.ndarray:
    """Gaussian targets ``(K, H, W)`` on the host: ``exp(-d² / 2σ²)`` within
    ``reach`` of each integer peak ``mu (K, 2)`` whose ``valid`` is above
    0.5, zero elsewhere."""
    lib = load()
    k = mu.shape[0]
    mu = np.ascontiguousarray(mu, np.int32)
    valid = _f32(valid)
    out = np.empty((k, h, w), np.float32)
    lib.render_gaussian_f32(_ptr(mu, ctypes.c_int32), _ptr(valid), k, h, w,
                            ctypes.c_float(sigma), reach, _ptr(out))
    return out


def render_gaussian_plain(mu: np.ndarray, valid: np.ndarray, h: int, w: int,
                          sigma: float = 2.0, reach: int = 6) -> np.ndarray:
    """numpy version of :func:`render_gaussian`."""
    k = mu.shape[0]
    out = np.zeros((k, h, w), np.float32)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    for j in range(k):
        if valid[j] <= 0.5:
            continue
        dx, dy = xs - mu[j, 0], ys - mu[j, 1]
        g = np.exp(-(dx**2 + dy**2) / (2 * sigma**2))
        g[(np.abs(dx) > reach) | (np.abs(dy) > reach)] = 0
        out[j] = g
    return out


def calc_dists(preds: np.ndarray, target: np.ndarray, normalize: np.ndarray) -> np.ndarray:
    """PCK distances on the host: ``preds``/``target (B, K, 2)``,
    ``normalize (B, 2)`` → ``(K, B)``, -1 where a target coordinate is not
    above 1 (``core.metrics.calc_dists``)."""
    lib = load()
    preds, target, normalize = _f32(preds), _f32(target), _f32(normalize)
    b, k, _ = preds.shape
    out = np.empty((k, b), np.float32)
    lib.calc_dists_f32(_ptr(preds), _ptr(target), _ptr(normalize), b, k, _ptr(out))
    return out


def calc_dists_plain(preds: np.ndarray, target: np.ndarray,
                     normalize: np.ndarray) -> np.ndarray:
    """numpy version of :func:`calc_dists`."""
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)
    diff = (preds - target) / normalize[:, None, :]
    d = np.sqrt(np.sum(diff * diff, axis=-1)).astype(np.float32)
    return np.where(valid, d, np.float32(-1.0)).T
