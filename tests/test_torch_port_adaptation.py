"""PyTorch port, the adaptation experiment
(``dahpe_tpu_torch/experiments/adaptation.py``) on the CPU at a toy size.

- A 2+2-iteration run of the ``micro`` backbone returns every key of the
  JAX package's result dict, each PCK in [0, 1].
- Its pieces against the JAX package on the same weights and split: the
  DA model's warm start from the pretrain weights (the key-filtered
  ``filtered_update``) equals JAX's leaf for leaf, and ``_eval_target``
  gives JAX's PCK on a device-resident target split.
- ``bf16`` runs: ``tests/test_torch_port_bf16.py``; over several ranks:
  ``tests/test_torch_port_adaptation_ranks.py``.

The acceptance run itself (resnet18 at 128², 4000+3000 iterations, seeds
0-2) runs on the card: see README.md and PERF.md.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.data.device_store import DeviceDataStore as JDeviceDataStore
from dahpe_tpu.data.synthetic import SyntheticHands as JSyntheticHands
from dahpe_tpu.evaluate import make_eval_step as j_make_eval_step
from dahpe_tpu.experiments.adaptation import _eval_target as j_eval_target
from dahpe_tpu.utils.torch_import import filtered_update as j_filtered_update
from tests.test_torch_port_models import jax_backbone, port_backbone, randomize_variables

from dahpe_tpu_torch import models
from dahpe_tpu_torch.data.device_store import DeviceDataStore
from dahpe_tpu_torch.data.synthetic import SyntheticHands
from dahpe_tpu_torch.evaluate import make_eval_step
from dahpe_tpu_torch.experiments import adaptation
from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax

IMAGE, HM, K = 64, 16, 21
RESULT_KEYS = {"shift", "content", "style", "source_val", "pretrain", "source_only", "da",
               "gain", "curve", "da_seconds", "da_ema"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _variables(jmodel, seed):
    x0 = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, x0, train=False), jax.random.key(0))
    return randomize_variables(shapes, seed)


def test_micro_run_returns_every_key():
    """2 pretrain + 2 control + 2 DA iterations of ``micro`` at 64²/16²,
    with the confidence gate and the EMA twin, on the CPU."""
    r = adaptation.run_adaptation_experiment(
        arch="micro", n_train=8, n_val=8, batch=4, pre_iters=2, da_iters=2, eval_every=1,
        conf_gate=0.5, shift=0.3, content=0.3, style=1.0, seed=1, device="cpu",
        verbose=False)
    assert set(r) == RESULT_KEYS
    for key in ("source_val", "pretrain", "source_only", "da", "da_ema"):
        assert 0.0 <= r[key] <= 1.0, key
    assert (r["shift"], r["content"], r["style"]) == (0.3, 0.3, 1.0)
    assert r["gain"] == pytest.approx(r["da"] - r["source_only"])
    assert [i for i, _ in r["curve"]] == [1, 2] and r["curve"][-1][1] == r["da"]
    assert r["da_seconds"] > 0


def test_warm_start_matches_jax():
    """The DA model (its own random weights) takes the pretrain model's
    backbone and upsampling; its heads keep theirs, as in JAX."""
    pre_j = jmodels.PoseResNet(backbone=jax_backbone("basic"), num_keypoints=K)
    da_j = jmodels.MultiHeadPoseResNet(backbone=jax_backbone("basic"), num_keypoints=K)
    pre_vars, da_vars = _variables(pre_j, 3), _variables(da_j, 4)
    warm = j_filtered_update(da_vars, pre_vars)
    da = models.MultiHeadPoseResNet(port_backbone("basic"), num_keypoints=K)
    da.load_state_dict(state_dict_from_jax(da_vars))
    adaptation.warm_start(da, state_dict_from_jax(pre_vars))
    want = state_dict_from_jax(warm)
    got = da.state_dict()
    assert set(want) <= set(got)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    before = state_dict_from_jax(da_vars)
    moved = [k for k in want if not torch.equal(want[k], before[k])]
    assert moved and all(k.startswith(("backbone.", "upsampling.")) for k in moved)


def test_eval_target_matches_jax():
    """``_eval_target`` on a device-resident target split of 16 frames at
    batch 8 (with ``micro`` weights the two packages share) gives the JAX
    package's PCK."""
    mk = dict(n=16, seed=2, image_size=(IMAGE, IMAGE), heatmap_size=(HM, HM), shift=0.3,
              content=0.3, style=1.0, domain="target", split="test")
    jmodel = jmodels.MultiHeadPoseResNet(backbone=jax_backbone("basic"), num_keypoints=K)
    variables = _variables(jmodel, 5)
    jds = JSyntheticHands(**mk)
    jloader = JDeviceDataStore(jds, shard_samples=False, raw_size=IMAGE,
                               verbose=False).eval_loader(8, heatmap_size=HM)
    want = j_eval_target(jmodel, jax.tree.map(jnp.asarray, variables), jloader, jds,
                         image_size=IMAGE, heatmap_size=HM, eval_step=j_make_eval_step(jmodel))
    model = models.MultiHeadPoseResNet(port_backbone("basic"), num_keypoints=K)
    model.load_state_dict(state_dict_from_jax(variables))
    ds = SyntheticHands(**mk)
    loader = DeviceDataStore(ds, device="cpu", raw_size=IMAGE, verbose=False).eval_loader(
        8, heatmap_size=HM)
    got = adaptation._eval_target(model, loader, ds, image_size=IMAGE, heatmap_size=HM,
                                  eval_step=make_eval_step(model, device="cpu"))
    assert 0.0 < float(want) < 1.0
    np.testing.assert_allclose(got, float(want), rtol=0, atol=1e-6)
