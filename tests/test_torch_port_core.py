"""PyTorch port, core math: ``dahpe_tpu_torch.core`` / ``ops`` against
``dahpe_tpu`` on the same numpy inputs.

The Gaussian renderer's plain version is held against both the JAX
``render_gaussian`` and the Pallas kernel in interpret mode (as
``tests/test_pallas_kernels.py`` runs it). The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.

Tolerances: the zero pattern, integer decodes and per-joint PCK are exact;
Gaussian values and PCK distances are within rtol 1e-6 (torch's and XLA's
``exp`` and ``sqrt`` inputs may differ by 1 ulp); the KL loss within rtol
1e-5 and means over joints within rtol 1e-6 (sums in another order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahpe_tpu.core import decode as jdecode
from dahpe_tpu.core import heatmap as jheatmap
from dahpe_tpu.core import losses as jlosses
from dahpe_tpu.core import metrics as jmetrics
from dahpe_tpu.ops.gradient_scale import warm_start_coeff as j_warm_start_coeff
from dahpe_tpu.ops.pallas.gaussian import render_gaussian_pallas
from tests.conftest import REPO_ROOT

from dahpe_tpu_torch.core import decode, heatmap, layout, losses, metrics
from dahpe_tpu_torch.ops import _build, gaussian, gradient_scale, warm_start_coeff

SCALES = [(64, 6), (32, 4), (16, 3)]  # (size, reach) of the 64/32/16 heads


def _peaks(rng, b, k, size):
    """Peaks that include negative and >= size coordinates, ~20% invalid."""
    mu = rng.integers(-8, size + 8, size=(b, k, 2)).astype(np.int32)
    valid = (rng.uniform(size=(b, k)) > 0.2).astype(np.float32)
    return mu, valid


def _assert_gaussian_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("size,reach", SCALES)
def test_render_gaussian_plain_matches_jax_and_pallas(size, reach):
    rng = np.random.default_rng(size)
    mu, valid = _peaks(rng, 4, 21, size)
    got = gaussian.render_gaussian_plain(
        torch.from_numpy(mu), torch.from_numpy(valid),
        height=size, width=size, sigma=2.0, reach=reach,
    ).numpy()
    ref = jheatmap.render_gaussian(
        jnp.asarray(mu), size, size, sigma=2.0, reach=reach, valid=jnp.asarray(valid)
    )
    pallas = render_gaussian_pallas(
        jnp.asarray(mu), jnp.asarray(valid), height=size, width=size,
        sigma=2.0, reach=reach, interpret=True,
    )
    _assert_gaussian_close(got, ref)
    _assert_gaussian_close(got, pallas)
    assert (got > 0).any() and (got == 0).any()


def test_render_gaussian_leading_dims_and_no_mask():
    rng = np.random.default_rng(5)
    mu = rng.integers(-4, 20, size=(2, 3, 21, 2)).astype(np.int32)
    got = heatmap.render_gaussian(torch.from_numpy(mu), 16, 12, sigma=2.0, reach=3)
    ref = jheatmap.render_gaussian(jnp.asarray(mu), 16, 12, sigma=2.0, reach=3)
    assert tuple(got.shape) == (2, 3, 16, 12, 21)
    _assert_gaussian_close(got.numpy(), ref)


def test_gaussian_window_reach_matches():
    for sigma, factor in ((2.0, 3.0), (2.0, 2.0), (2.0, 1.5), (1.5, 3.0)):
        assert heatmap.gaussian_window_reach(sigma, factor) == (
            jheatmap.gaussian_window_reach(sigma, factor)
        )


@pytest.mark.parametrize("hm,img", [(64, 256), (16, 64)])
def test_generate_target_matches_jax(hm, img):
    rng = np.random.default_rng(hm)
    # keypoints spill off both sides of the image: negative peaks, peaks at
    # and past the last heatmap column, and the trunc(x + 0.5) rounding edge
    kp = rng.uniform(-0.2 * img, 1.2 * img, size=(6, 21, 2)).astype(np.float32)
    kp[0, :4] = [[-2.1, 5.0], [img - 1.0, img - 2.0], [img + 3.0, 1.0], [1.99, 2.0]]
    vis = (rng.uniform(size=(6, 21)) > 0.2).astype(np.float32)
    target, weight = heatmap.generate_target(
        torch.from_numpy(kp), torch.from_numpy(vis), (hm, hm), (img, img)
    )
    jt, jw = jheatmap.generate_target(jnp.asarray(kp), jnp.asarray(vis), (hm, hm), (img, img))
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jw))
    assert 0 < weight.numpy().sum() < weight.numel()
    _assert_gaussian_close(target.numpy(), jt)


def _tie_heatmaps(rng, b=4, h=16, w=16, k=21):
    y = rng.standard_normal((b, h, w, k)).astype(np.float32)
    # ties: the max value placed twice; the first in flat order must win
    for bi in range(b):
        for ki in range(0, k, 3):
            flat = y[bi, :, :, ki].reshape(-1)
            i, j = sorted(rng.choice(h * w, size=2, replace=False))
            flat[i] = flat[j] = flat.max() + 1.0
            y[bi, :, :, ki] = flat.reshape(h, w)
    y[:, :, :, 1] = -np.abs(y[:, :, :, 1])  # all <= 0: decode to the origin
    y[0, :, :, 2] = 0.0
    return y


def test_get_max_preds_and_peaks_match_jax():
    y = _tie_heatmaps(np.random.default_rng(0))
    preds, maxvals = decode.get_max_preds(torch.from_numpy(y))
    jp, jm = jdecode.get_max_preds(jnp.asarray(y))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(jm))
    assert (preds.numpy()[:, 1] == 0).all()
    peaks = heatmap.peaks_from_heatmap(torch.from_numpy(y))
    assert peaks.dtype == torch.int32
    np.testing.assert_array_equal(
        peaks.numpy(), np.asarray(jheatmap.peaks_from_heatmap(jnp.asarray(y)))
    )


def test_pck_and_group_accuracy_match_jax():
    rng = np.random.default_rng(1)
    out = _tie_heatmaps(rng)
    # targets near the outputs' peaks so hits and misses both occur; joint 5
    # has no valid target (all-zero maps decode to the origin → -1)
    kp = rng.uniform(0, 64, size=(4, 21, 2)).astype(np.float32)
    vis = np.ones((4, 21), np.float32)
    vis[:, 5] = 0
    tgt, _ = jheatmap.generate_target(jnp.asarray(kp), jnp.asarray(vis), (16, 16), (64, 64))
    tgt = np.array(tgt)
    out[:2] = tgt[:2] + 0.01 * rng.standard_normal(tgt[:2].shape).astype(np.float32)

    acc, avg, cnt, pred = metrics.pck_accuracy(torch.from_numpy(out), torch.from_numpy(tgt))
    ja, jv, jc, jp = jmetrics.pck_accuracy(jnp.asarray(out), jnp.asarray(tgt))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
    assert int(cnt) == int(jc)
    # the mean over joints sums thirds and quarters: only the order differs
    np.testing.assert_allclose(float(avg), float(jv), rtol=1e-6)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jp))
    assert acc.numpy()[5] == -1 and (acc.numpy() > 0).any()

    groups = {"MCP": [1, 5, 9, 13, 17], "none": [5], "all": list(range(21))}
    got = metrics.group_accuracy(acc, groups)
    ref = jmetrics.group_accuracy(ja, groups)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=1e-6)
    assert float(got["none"]) == -1.0


def test_calc_dists_and_dist_acc_match_jax():
    rng = np.random.default_rng(2)
    preds = rng.integers(0, 16, size=(5, 21, 2)).astype(np.float32)
    target = rng.integers(0, 16, size=(5, 21, 2)).astype(np.float32)
    target[:, 3] = 0.0  # invalid joint for every sample
    norm = np.full((5, 2), 1.6, np.float32)
    d = metrics.calc_dists(*map(torch.from_numpy, (preds, target, norm)))
    jd = jmetrics.calc_dists(*map(jnp.asarray, (preds, target, norm)))
    # XLA may contract dx*dx + dy*dy into an FMA: 1 ulp before the sqrt
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_array_equal(d.numpy() == -1, np.asarray(jd) == -1)
    np.testing.assert_array_equal(
        metrics.dist_acc(d).numpy(), np.asarray(jmetrics.dist_acc(d.numpy()))
    )


@pytest.mark.parametrize("epsilon", [0.0, 1e-3])
def test_losses_match_jax(epsilon):
    rng = np.random.default_rng(3)
    out = rng.standard_normal((3, 16, 16, 21)).astype(np.float32)
    kp = rng.uniform(0, 64, size=(3, 21, 2)).astype(np.float32)
    tgt, w = jheatmap.generate_target(
        jnp.asarray(kp), jnp.ones((3, 21)), (16, 16), (64, 64)
    )
    tgt, w = np.array(tgt), np.array(w)
    tgt[0, :, :, 4] = 0.0  # all-zero target joint: guarded, contributes 0
    t_out, t_tgt, t_w = map(torch.from_numpy, (out, tgt, w))
    for red in ("none", "mean"):
        kl = losses.joints_kl_loss(t_out, t_tgt, t_w, epsilon=epsilon, reduction=red)
        jkl = jlosses.joints_kl_loss(
            jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w),
            epsilon=epsilon, reduction=red,
        )
        assert np.isfinite(kl.numpy()).all()
        np.testing.assert_allclose(kl.numpy(), np.asarray(jkl), rtol=1e-5)
        mse = losses.joints_mse_loss(t_out, t_tgt, t_w, reduction=red)
        jmse = jlosses.joints_mse_loss(
            jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w), reduction=red
        )
        np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5)
    with pytest.raises(ValueError):
        losses.joints_kl_loss(t_out, t_tgt, reduction="sum")


def test_gradient_scale_and_warm_start_coeff():
    x = torch.randn(2, 3, requires_grad=True)
    y = gradient_scale(x, 0.25)
    assert torch.equal(y, x)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full((2, 3), 0.25, np.float32))
    for step in (0, 1, 500, 1000, 5000):
        # 2·span/(1+e) - span cancels near step 0: compare absolutely
        np.testing.assert_allclose(
            float(warm_start_coeff(step)), float(j_warm_start_coeff(step)), atol=1e-7
        )


def test_layout_round_trip_is_a_view():
    x = torch.arange(2 * 4 * 5 * 3).reshape(2, 4, 5, 3)
    nchw = layout.to_bkhw(x)
    assert tuple(nchw.shape) == (2, 3, 4, 5)
    assert nchw.data_ptr() == x.data_ptr()
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(layout.from_bkhw(nchw), x)


def test_render_gaussian_wrapper_never_falls_back():
    """CPU tensors take the plain version; a CUDA call takes the kernel or
    raises, and other devices raise."""
    mu = torch.zeros((1, 21, 2), dtype=torch.int32)
    valid = torch.ones((1, 21))
    out = gaussian.render_gaussian(mu, valid, height=8, width=8, reach=3)
    assert tuple(out.shape) == (1, 8, 8, 21)
    with pytest.raises(ValueError):
        gaussian.render_gaussian_cuda(mu, valid, height=8, width=8)
    with pytest.raises(ValueError):
        gaussian.render_gaussian(mu.to("meta"), valid.to("meta"), height=8, width=8)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_port_imports_no_jax():
    """Every module of the port loads without JAX, Flax or dahpe_tpu."""
    code = (
        "import pkgutil, sys, importlib, dahpe_tpu_torch\n"
        "for m in pkgutil.walk_packages(dahpe_tpu_torch.__path__, 'dahpe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import dahpe_tpu_torch.train.da, dahpe_tpu_torch.ops.shear, dahpe_tpu_torch.ops.pseudo_label\n"
        "bad = [k for k in sys.modules if k in ('jax', 'flax', 'dahpe_tpu')\n"
        "       or k.startswith(('jax.', 'flax.', 'dahpe_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('dahpe_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # the training slice's modules are among those walked and imported
    assert int(proc.stdout.strip()) >= 35
