"""PyTorch port, ``--host-warp``: the native library
(``dahpe_tpu_torch/utils/native.py`` over ``dahpe_tpu_torch/native/
dahpe_native.cpp``), ``data/host_warp.py``, ``fetch_warped``,
``BatchLoader(warped=True)`` and ``cli.train --host-warp``, against the JAX
package on the same inputs and ``numpy.random.default_rng`` seeds.

Both libraries are the same source built with the same ``g++`` flags, so
where both load their outputs are compared bit for bit; against the JAX
package's numpy fallback the tolerances are ``tests/test_native.py``'s
(warp rtol/atol 1e-4, Gaussians rtol 1e-5 / atol 1e-6, the fused
augmentation 1e-3), and the port's numpy versions equal that fallback
exactly.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

from dahpe_tpu import data as jdata
from dahpe_tpu.core import metrics as jmetrics
from dahpe_tpu.data import host_warp as jhost_warp
from dahpe_tpu.data.cache import DecodedCache as JDecodedCache
from dahpe_tpu.data.pipeline import BatchLoader as JBatchLoader
from dahpe_tpu.utils import native as jnative
from tests.conftest import REPO_ROOT
from tests.fixtures import make_h3d_fixture, make_rhd_fixture

from dahpe_tpu_torch import data
from dahpe_tpu_torch.cli import train as train_cli
from dahpe_tpu_torch.data import host_warp
from dahpe_tpu_torch.data.pipeline import BatchLoader
from dahpe_tpu_torch.utils import native


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("host_warp")
    return (make_rhd_fixture(str(base / "rhd"), n=6, sets=("training", "evaluation")),
            make_h3d_fixture(str(base / "h3d"), n=20))


@pytest.fixture
def jax_numpy_fallback():
    """The JAX package's numpy branches (its library unloaded, as
    ``tests/test_native.py`` forces them)."""
    lib, tried = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    yield
    jnative._lib, jnative._tried = lib, tried


def _warp_inputs():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, size=(80, 90, 3), dtype=np.uint8)
    ang = np.deg2rad(23.0)
    mat = np.asarray([[np.cos(ang) * 0.7, -np.sin(ang) * 0.7],
                      [np.sin(ang) * 0.7, np.cos(ang) * 0.7]], np.float32)
    return src, mat, np.asarray([5.0, -3.0], np.float32)


def _gaussian_inputs():
    rng = np.random.default_rng(1)
    return (rng.integers(-3, 67, size=(21, 2)).astype(np.int32),
            (rng.uniform(size=21) > 0.2).astype(np.float32))


def _augment_inputs():
    src = np.random.default_rng(1).integers(0, 255, (120, 130, 3), dtype=np.uint8)
    mat, off, _, _, _ = jhost_warp.sample_affine(np.random.default_rng(3), 120, 130, 64,
                                                 180.0, (0.6, 1.3))
    return src, mat, off, np.asarray([2, 0, 1], np.int32), np.asarray([1.2, 0.8, 1.1]), 0.6


def _dists_inputs():
    rng = np.random.default_rng(4)
    preds = rng.uniform(0, 16, (5, 21, 2)).astype(np.float32)
    target = rng.uniform(-1, 16, (5, 21, 2)).astype(np.float32)
    return preds, target, np.full((5, 2), 1.6, np.float32)


def _jax_calc_dists_library(preds, target, norm):
    """The JAX package's library's ``calc_dists_f32`` (it has no Python
    wrapper there)."""
    lib = jnative._load()
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.calc_dists_f32.argtypes = [f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, f32p]
    b, k, _ = preds.shape
    out = np.empty((k, b), np.float32)
    lib.calc_dists_f32(*(a.ctypes.data_as(f32p) for a in (preds, target, norm)), b, k,
                       out.ctypes.data_as(f32p))
    return out


def test_native_build_lands_in_build_and_rebuilds_when_the_source_changes(tmp_path,
                                                                          monkeypatch):
    """The library is ``build/native/libdahpe_native-<hash>.so`` (never
    under ``native/``); a changed source hashes to a new name and builds it;
    a source that does not compile raises with the compiler's error."""
    native.load()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO_ROOT, "build", "native")
    assert os.path.isfile(path)
    edited = tmp_path / "dahpe_native.cpp"
    edited.write_text(open(native.SOURCE).read() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(edited))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    new = native.library_path()
    assert new != path and not os.path.exists(new)
    built, record = native.build()
    assert built == new and record["built"] and os.path.isfile(new)
    assert native.build()[1]["built"] is False  # the hash names a built library
    edited.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_affine_warp_matches_jax(jax_numpy_fallback):
    src, mat, off = _warp_inputs()
    got = native.affine_warp(src, mat, off, (64, 64))
    plain = native.affine_warp_plain(src, mat, off, (64, 64))
    np.testing.assert_array_equal(plain, jnative.affine_warp(src, mat, off, (64, 64)))
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
    jnative._tried = False  # the JAX package's library
    np.testing.assert_array_equal(got, jnative.affine_warp(src, mat, off, (64, 64)))


def test_resize_norm_matches_jax(jax_numpy_fallback):
    src = np.random.default_rng(2).integers(0, 255, size=(48, 52, 3), dtype=np.uint8)
    got = native.resize_norm(src, 64)
    plain = native.resize_norm_plain(src, 64)
    np.testing.assert_array_equal(plain, jnative.resize_norm(src, 64))
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
    jnative._tried = False
    np.testing.assert_array_equal(got, jnative.resize_norm(src, 64))


def test_render_gaussian_matches_jax(jax_numpy_fallback):
    mu, valid = _gaussian_inputs()
    got = native.render_gaussian(mu, valid, 64, 64)
    plain = native.render_gaussian_plain(mu, valid, 64, 64)
    np.testing.assert_array_equal(plain, jnative.render_gaussian(mu, valid, 64, 64))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    jnative._tried = False
    np.testing.assert_array_equal(got, jnative.render_gaussian(mu, valid, 64, 64))


def test_fused_augment_matches_jax(jax_numpy_fallback):
    """The library call against the JAX package's fallback chain (which
    ``augment_plain`` equals) and against its library's call."""
    src, mat, off, ops, factors, sigma = _augment_inputs()
    got = native.fused_augment(src, mat, off, 64, ops, factors, sigma)
    plain = host_warp.augment_plain(src, mat, off, 64, ops, factors, sigma)
    raw = jnative.affine_warp(src, mat, off, (64, 64), mean=np.zeros(3, np.float32),
                              std=np.full(3, 1 / 255, np.float32))
    for op, f in zip(ops, factors):
        raw = jhost_warp._apply_jitter_op(raw, int(op), float(f))
    raw = jhost_warp._gaussian_blur_sigma(raw, sigma)
    want = (raw.astype(np.float32) / 255.0 - jhost_warp.IMAGENET_MEAN) / jhost_warp.IMAGENET_STD
    np.testing.assert_array_equal(plain, want.astype(np.float32))
    np.testing.assert_allclose(got, plain, rtol=1e-3, atol=1e-3)
    jnative._tried = False
    np.testing.assert_array_equal(got, jnative.fused_augment(src, mat, off, 64, ops, factors,
                                                             sigma))


def test_calc_dists_matches_jax():
    """The port's ``calc_dists_f32`` against the JAX package's library bit for
    bit, and its numpy version and the JAX metric within 1e-6 relative."""
    preds, target, norm = _dists_inputs()
    got = native.calc_dists(preds, target, norm)
    np.testing.assert_array_equal(got, _jax_calc_dists_library(preds, target, norm))
    want = np.asarray(jmetrics.calc_dists(preds, target, norm))
    np.testing.assert_allclose(native.calc_dists_plain(preds, target, norm), want, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize("jitter,blur", [(0.25, 0.8), (0.0, 0.0)])
def test_warp_augment_matches_jax(jitter, blur):
    """Equal ``default_rng`` seeds give the JAX package's sample bit for bit
    and leave both generators in the same state."""
    src = np.random.default_rng(1).integers(0, 255, (120, 130, 3), dtype=np.uint8)
    kp = np.random.default_rng(2).uniform(0, 120, (21, 2)).astype(np.float32)
    intr = np.asarray([[200.0, 0, 60], [0, 200.0, 65], [0, 0, 1]], np.float32)
    for seed in range(4):
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        got = host_warp.warp_augment(src, kp, intr, r_port, out_size=64, jitter=jitter,
                                     blur=blur)
        want = jhost_warp.warp_augment(src, kp, intr, r_jax, out_size=64, jitter=jitter,
                                       blur=blur)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert r_port.uniform() == r_jax.uniform()


def test_fetch_warped_matches_jax(roots, tmp_path):
    """A dataset's ``fetch_warped`` and the decoded cache's, on the fixture
    RHD split, against the JAX package's with equal seeds."""
    rhd, _ = roots
    kw = dict(root=rhd, split="train", image_size=(64, 64), heatmap_size=(16, 16))
    ref = jdata.get_dataset("RenderedHandPose", **kw)
    got = data.get_dataset("RenderedHandPose", **kw)
    jc = JDecodedCache(ref, str(tmp_path / "cache"), raw_size=96, num_workers=1)
    pc = data.DecodedCache(got, str(tmp_path / "cache"), raw_size=96, build=False)
    for source_ref, source_got in ((ref, got), (jc, pc)):
        for i in range(len(ref)):
            a = source_ref.fetch_warped(i, np.random.default_rng(i), image_size=64)
            b = source_got.fetch_warped(i, np.random.default_rng(i), image_size=64)
            assert set(a) == set(b) == {"image", "keypoint2d", "visible", "intrinsic_matrix"}
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)


def test_warped_batch_loader_epoch_matches_jax(roots):
    """Two epochs of ``BatchLoader(warped=True)`` (one worker, whose
    generator both packages seed alike) equal the JAX package's batches."""
    _, h3d = roots
    kw = dict(root=h3d, split="train", image_size=(64, 64), heatmap_size=(16, 16))
    ref = JBatchLoader(jdata.get_dataset("Hand3DStudio", **kw), 4, num_workers=1, seed=3,
                       warped=True, image_size=64)
    got = BatchLoader(data.get_dataset("Hand3DStudio", **kw), 4, num_workers=1, seed=3,
                      warped=True, image_size=64)
    n = 0
    for _ in range(2):
        for a, b in zip(ref, got, strict=True):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert b["image"].shape == (4, 64, 64, 3)
            n += 1
    assert n == 2 * len(got) > 0


def _argv(roots, log, *extra):
    rhd, h3d = roots
    return [h3d, "--source_root", rhd, "-t", "Hand3DStudio", "-a", "resnet18", "-b", "2",
            "-i", "1", "--workers", "2", "--print-freq", "1", "--image-size", "64",
            "--heatmap-size", "16", "--device", "cpu", "--log", str(log),
            "--pretrain-epochs", "0", "--epochs", "1", "--host-warp", *extra]


def test_cli_host_warp_runs_a_da_step(roots, tmp_path, monkeypatch):
    """``cli.train --host-warp --device cpu``: one DA step on warped batches
    (through the decoded cache), finite losses, the epoch checkpoint."""
    torch.set_num_threads(min(2, torch.get_num_threads()))
    fetched = []
    real = data.DecodedCache.fetch_warped

    def counting(self, *a, **kw):
        fetched.append(kw["image_size"])
        return real(self, *a, **kw)

    monkeypatch.setattr(data.DecodedCache, "fetch_warped", counting)
    log = tmp_path / "logs"
    assert train_cli.cli_main(_argv(roots, log, "--decoded-cache",
                                    str(tmp_path / "cache"))) == 0
    (da,) = [r for r in map(json.loads, open(log / "metrics.jsonl"))
             if r["kind"] == "da_epoch"]
    assert all(np.isfinite(da[k]) for k in ("loss_s", "loss_gf", "loss_gt"))
    assert fetched and set(fetched) == {64}
    assert os.path.isdir(log / "checkpoints" / "0")


def test_cli_host_warp_without_its_library_raises(roots, tmp_path, monkeypatch):
    """No numpy fallback: a library that does not build stops the run with
    the compiler's error before any batch is drawn."""
    broken = tmp_path / "dahpe_native.cpp"
    broken.write_text("not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        train_cli.cli_main(_argv(roots, tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_warp.warp_augment(np.zeros((32, 32, 3), np.uint8), np.zeros((21, 2), np.float32),
                               np.eye(3, dtype=np.float32), np.random.default_rng(0),
                               out_size=16)
