"""PyTorch port, the model zoo's and metrics' loose ends against the JAX
package on the same numpy inputs and carried weights: ``RegDAPoseResNet``
(forward, disparity, initialisation, registry), ``core/decode.py``'s
soft-argmax and upsample-then-argmax decodes, ``core/metrics.py``'s joint
errors and 3-D PCK-AUC, ``data/device_aug.py:resize_batch`` and
``Body16KeypointDataset``.

Tolerances: the forward and the disparities rtol 2e-3 with atol
``max(2e-4, 1e-4·std)`` (``tests/test_full_model_parity.py:119-124``);
the decodes and metrics rtol 1e-5 (argmax coordinates exactly);
``resize_batch``'s images atol 1e-5 in normalised units (the antialiased
shrink reaches 1.4e-6 against ``jax.image.resize``), its keypoints and
intrinsics exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.core import decode as jdecode
from dahpe_tpu.core import metrics as jmetrics
from dahpe_tpu.data import device_aug as jdevice_aug
from dahpe_tpu.data.datasets.base import Body16KeypointDataset as JBody16
from dahpe_tpu.train.disparity import rd_plain as jrd_plain
from tests.test_torch_port_models import (
    assert_forward_close,
    jax_backbone,
    port_backbone,
    randomize_variables,
)

from dahpe_tpu_torch import models
from dahpe_tpu_torch.core import decode, metrics
from dahpe_tpu_torch.data import device_aug
from dahpe_tpu_torch.data.datasets.base import Body16KeypointDataset
from dahpe_tpu_torch.train.disparity import rd_plain
from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax

K = 5


@pytest.fixture(scope="module")
def regda_pair():
    jmodel = jmodels.RegDAPoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=K)
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, jnp.zeros((1, 64, 64, 3)), train=False, gl_coeff=0.0),
        jax.random.key(0))
    variables = randomize_variables(shapes, 3)
    model = models.RegDAPoseResNet(port_backbone("bottleneck"), num_keypoints=K)
    model.load_state_dict(state_dict_from_jax(variables))  # strict: every key carried
    return jmodel, variables, model.eval()


def test_regda_forward_and_disparity_match_jax(regda_pair):
    """Every output of the eval forward (``y_adv2`` is what eval reads), and
    the RegDA disparity of ``y_adv`` in both modes."""
    jmodel, variables, model = regda_pair
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False, gl_coeff=0.0)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(ref) == {"y", "y_adv", "y_adv2", "f"}
    assert got["y_adv2"].shape == (2, 16, 16, K)
    for name in ref:
        assert_forward_close(got[name], ref[name], name)
    rng = np.random.default_rng(0)
    y = rng.standard_normal((2, 16, 16, K)).astype(np.float32)
    w = np.ones((2, K), np.float32)
    for mode in ("min", "max"):
        want = float(jrd_plain(jnp.asarray(y), ref["y_adv"], jnp.asarray(w), mode))
        have = float(rd_plain(torch.from_numpy(y), got["y_adv"], torch.from_numpy(w), mode))
        assert np.isfinite(have)
        np.testing.assert_allclose(have, want, rtol=2e-3, err_msg=mode)


def test_regda_registry_and_initialisation_match_jax():
    """The registry exports the model; a fresh one starts from the JAX
    package's initial distributions (the rule of
    ``tests/test_torch_port_models.py::test_initialisation_matches_jax``)."""
    assert "RegDAPoseResNet" in models.__all__
    jmodel = jmodels.RegDAPoseResNet(backbone=jax_backbone("basic"), num_keypoints=21)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    torch.manual_seed(0)
    got = models.RegDAPoseResNet(port_backbone("basic"), num_keypoints=21).state_dict()
    assert set(want) == set(got)
    for key, w in want.items():
        g, w = got[key].double(), w.double()
        if torch.all(w == w.flatten()[0]):
            assert torch.equal(g, w), key
            continue
        if w.numel() >= 2048:
            np.testing.assert_allclose(float(g.std()), float(w.std()), rtol=0.1, err_msg=key)
        if key.startswith("backbone"):
            fan_out = g.shape[0] * g[0, 0].numel()
            bound = 2 * (2.0 / fan_out) ** 0.5 / 0.87962566103423978
        else:
            bound = 6e-3
        assert float(g.abs().max()) <= bound * (1 + 1e-6), key


def _heatmaps(seed, b=2, h=16, w=16, k=4):
    """Peaked random heatmaps (B, H, W, K): one clear maximum per joint."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, 0.1, (b, h, w, k)).astype(np.float32)
    for i in range(b):
        for j in range(k):
            y[i, rng.integers(1, h - 1), rng.integers(1, w - 1), j] = 1.0
    return y


@pytest.mark.parametrize("temperature,scale", [(100.0, 4.0), (3.0, 1.0)])
def test_soft_argmax_decode_matches_jax(temperature, scale):
    y = _heatmaps(2, h=64, w=48)
    want = jdecode.soft_argmax_decode(jnp.asarray(y), temperature=temperature, scale=scale)
    got = decode.soft_argmax_decode(torch.from_numpy(y), temperature=temperature, scale=scale)
    assert got.shape == (2, 4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_uv_from_heatmaps_matches_jax():
    y = _heatmaps(3)
    want = np.asarray(jdecode.decode_uv_from_heatmaps(jnp.asarray(y), (64, 64)))
    got = decode.decode_uv_from_heatmaps(torch.from_numpy(y), (64, 64)).numpy()
    np.testing.assert_array_equal(got, want)


def test_joint_errors_and_pck_auc_match_jax():
    rng = np.random.default_rng(5)
    p2, t2 = (rng.uniform(0, 64, (3, 21, 2)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(metrics.mean_joint_error_2d(torch.from_numpy(p2),
                                                                 torch.from_numpy(t2))),
                               float(jmetrics.mean_joint_error_2d(p2, t2)), rtol=1e-5)
    t3 = rng.uniform(-0.2, 0.2, (3, 21, 3)).astype(np.float32)
    p3 = t3 + rng.normal(0, 0.02, t3.shape).astype(np.float32)  # errors around 20-50 mm
    np.testing.assert_allclose(float(metrics.mean_joint_error_3d(torch.from_numpy(p3),
                                                                 torch.from_numpy(t3))),
                               float(jmetrics.mean_joint_error_3d(p3, t3)), rtol=1e-5)
    err, auc = metrics.pck_auc_3d(torch.from_numpy(p3), torch.from_numpy(t3))
    jerr, jauc = jmetrics.pck_auc_3d(p3, t3)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-5)
    np.testing.assert_allclose(float(auc), float(jauc), rtol=1e-5)
    assert 0.0 < float(auc) < 1.0


@pytest.mark.parametrize("size,out", [(288, 256), (120, 64), (48, 64), (100, 37)])
def test_resize_batch_matches_jax(size, out):
    """The eval resize, shrinking (288² store → 256², antialiased as
    ``jax.image.resize`` is) and enlarging."""
    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (2, size, size, 3)).astype(np.uint8)
    kp = rng.uniform(0, size, (2, 21, 2)).astype(np.float32)
    intr = np.tile(np.asarray([[100.0, 0, 60], [0, 110.0, 50], [0, 0, 1]], np.float32),
                   (2, 1, 1))
    want = jdevice_aug.resize_batch(jnp.asarray(img, jnp.float32), jnp.asarray(kp),
                                    jnp.asarray(intr), out_size=out)
    got = device_aug.resize_batch(torch.from_numpy(img), torch.from_numpy(kp),
                                  torch.from_numpy(intr), out_size=out)
    assert got[0].shape == (2, out, out, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_body16_groups_match_jax():
    """The reference's 16-joint grouping, and its per-group accuracy."""
    got, want = Body16KeypointDataset("", []), JBody16("", [])
    assert got.num_keypoints == want.num_keypoints == 16
    assert got.keypoints_group == want.keypoints_group
    acc = np.random.default_rng(6).uniform(-1, 1, 16).tolist()
    assert got.group_accuracy(acc) == want.group_accuracy(acc)
