"""PyTorch port, training: disparity losses, schedules, EMA, the DA and
pretrain steps and the weight carrier's state transfer, against
``dahpe_tpu`` on the same weights and batches.

Models are the mini ``[1, 1, 1, 1]`` backbones of
``tests/test_torch_port_models.py`` at 64² input (16² heatmaps). Two DA
iterations are held to ``tests/test_da_parity.py:221``'s tolerance, rtol
5e-3 / atol 5e-5 on every parameter and BN statistic: the two packages sum
float32 convolutions in different orders, and SGD carries the difference
into the next iteration. Each run prints the share of that tolerance its
worst entry uses. The weights follow that test's recipe (``0.05·randn``,
random BN statistics): with fan-in-scaled weights, train-mode BN over the
adversarial heads' 8² and 4² maps makes the Step B gradients ill-conditioned
(JAX against itself moves by 1-4x the tolerance from a 1e-6 change of the
weights), and no package pair could be held to it. Because those weights
make each update small beside atol, the losses of every iteration (rtol
1e-4) and each tensor's update over the two iterations (within 5% of the
JAX package's, norm-wise; the float noise is ~2%) are held too. The seeds
keep every main-head peak ahead of its runner-up by far more than the
forward tolerance, so no argmax (and no pseudo-label) differs between the
packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.core.decode import upsample_bilinear as j_upsample_bilinear
from dahpe_tpu.core.heatmap import peaks_from_heatmap as j_peaks
from dahpe_tpu.train import DATrainState as JDATrainState
from dahpe_tpu.train import PretrainState as JPretrainState
from dahpe_tpu.train import disparity as jdisparity
from dahpe_tpu.train import make_da_train_step as j_make_da_train_step
from dahpe_tpu.train import make_pretrain_step as j_make_pretrain_step
from dahpe_tpu.train.ema import ema_update as j_ema_update
from dahpe_tpu.train.optim import DA_PARTITIONS as J_DA_PARTITIONS
from dahpe_tpu.train.optim import da_lr as j_da_lr
from dahpe_tpu.train.optim import init_partitioned, torch_sgd
from dahpe_tpu.train.optim import pretrain_lr_factor as j_pretrain_lr_factor
from dahpe_tpu.train.pretrain import PRETRAIN_PARTITIONS as J_PRETRAIN_PARTITIONS
from tests.test_torch_port_models import _map_tree, jax_backbone, port_backbone

from dahpe_tpu_torch import models
from dahpe_tpu_torch.core.decode import upsample_bilinear
from dahpe_tpu_torch.core.heatmap import peaks_from_heatmap
from dahpe_tpu_torch.train import (
    create_da_state,
    create_pretrain_state,
    disparity,
    make_da_train_step,
    make_fused_da_iteration,
    make_fused_pretrain_iteration,
    make_pretrain_step,
)
from dahpe_tpu_torch.train.ema import ema_state, ema_update
from dahpe_tpu_torch.train.optim import da_lr, pretrain_lr_factor
from dahpe_tpu_torch.utils.torch_import import da_state_from_jax, state_dict_from_jax

K, IMAGE, HM, B = 21, 64, 16, 2
RTOL, ATOL = 5e-3, 5e-5
UPDATE_RTOL = 0.05  # per-tensor |Δport - Δjax| / |Δjax| over two iterations

# (share_target_features, conf_gate, ema_decay) -> jitted JAX step
_JAX_STEPS = {}


def _jax_step(share, gate, ema, jmodel):
    key = (share, gate, ema)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(j_make_da_train_step(
            jmodel, compute_metrics=False, share_target_features=share,
            conf_gate=gate, ema_decay=ema,
        ))
    return _JAX_STEPS[key]


def _batches(seed, n=2):
    """``n`` (source, target) pairs of numpy batches: images, non-negative
    heatmap targets, 0/1 joint weights."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pair = []
        for _ in range(2):
            pair.append({
                "image": rng.standard_normal((B, IMAGE, IMAGE, 3)).astype(np.float32),
                "target": np.clip(rng.standard_normal((B, HM, HM, K)), 0, None).astype(np.float32),
                "weight": (rng.uniform(size=(B, K)) > 0.2).astype(np.float32),
            })
        out.append(tuple(pair))
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def da_variables(jmodel, seed, **init_kw):
    """``tests/test_da_parity.py``'s weights for a Flax model: every
    parameter ``0.05·randn``; BN means ``0.5·randn``, variances U(0.5, 1.5)."""
    x0 = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, x0, train=False, **init_kw),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def stat(path, v):
        if path[-1] == "mean":
            return (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
        return (rng.uniform(size=np.shape(v)) + 0.5).astype(np.float32)

    return {
        "params": _map_tree(lambda _, v: (0.05 * rng.standard_normal(np.shape(v))).astype(
            np.float32), shapes["params"]),
        "batch_stats": _map_tree(stat, shapes["batch_stats"]),
    }


@pytest.fixture(scope="module")
def da_setup():
    """The mini JAX model and random weights, and a fresh JAX DA state
    factory holding them (with or without EMA)."""
    jmodel = jmodels.MultiHeadPoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=K)
    variables = da_variables(jmodel, 0, gl_coeff=0.0)

    def jax_state(with_ema):
        # what create_da_state builds, without compiling the model's init
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        return JDATrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt=init_partitioned(torch_sgd(), params, J_DA_PARTITIONS),
            ema_params=params if with_ema else None,
            ema_batch_stats=stats if with_ema else None,
        )

    return jmodel, variables, jax_state


def _port_model(variables):
    model = models.MultiHeadPoseResNet(port_backbone("bottleneck"), num_keypoints=K)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


def _worst_and_check(jax_tree, port_tensors, what):
    """Every entry within RTOL/ATOL; returns the share of that tolerance the
    worst entry uses, max |got - ref| / (ATOL + RTOL·|ref|) (< 1 passes)."""
    ref = state_dict_from_jax(jax_tree)
    worst = 0.0
    for key, got in port_tensors.items():
        if key.endswith("num_batches_tracked"):
            continue
        r, g = ref[key].numpy(), got.detach().numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=f"{what} {key}")
        worst = max(worst, float(np.max(np.abs(g - r) / (ATOL + RTOL * np.abs(r)))))
    return worst


def _check_updates(jax_tree, port_tensors, start):
    """Each tensor's change from ``start`` within UPDATE_RTOL of the JAX
    package's change (norm-wise); returns the worst ratio."""
    ref, init = state_dict_from_jax(jax_tree), state_dict_from_jax(start)
    worst = 0.0
    for key, got in port_tensors.items():
        if key.endswith("num_batches_tracked"):
            continue
        dj = ref[key].numpy() - init[key].numpy()
        dp = got.detach().numpy() - init[key].numpy()
        ratio = float(np.linalg.norm(dp - dj) / max(float(np.linalg.norm(dj)), 1e-12))
        assert ratio <= UPDATE_RTOL, f"update of {key}: {ratio:.3f} of the JAX update off"
        worst = max(worst, ratio)
    return worst


def _check_state(jstate, state, what):
    worst = _worst_and_check(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        state.model.state_dict(), what)
    if state.ema is not None:
        worst = max(worst, _worst_and_check(
            {"params": jstate.ema_params, "batch_stats": jstate.ema_batch_stats},
            state.ema, f"{what} ema"))
    return worst


@pytest.mark.parametrize("mode", ["min", "max"])
def test_rd_losses_match_jax(mode):
    """rd_64 / rd_32 / rd_16 (labels from the plain label functions on the
    CPU) equal the JAX losses to rtol 1e-6, with and without the decoded
    peaks passed in."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 64, 64, K)).astype(np.float32)
    adv = {s: rng.standard_normal((2, s, s, K)).astype(np.float32) for s in (64, 32, 16)}
    fused = {s: rng.uniform(0, 1, (2, s, s, K)).astype(np.float32) for s in (64, 32)}
    w = (rng.uniform(size=(2, K)) > 0.2).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    j = jnp.asarray
    f64, f32 = (fused[64], fused[32]) if mode == "max" else (None, None)
    cases = [
        (disparity.rd_64(t(y), t(adv[64]), None if f64 is None else t(f64), t(w), mode),
         jdisparity.rd_64(j(y), j(adv[64]), None if f64 is None else j(f64), j(w), mode)),
        (disparity.rd_32(t(y), t(adv[32]), None if f32 is None else t(f32), t(w), mode),
         jdisparity.rd_32(j(y), j(adv[32]), None if f32 is None else j(f32), j(w), mode)),
        (disparity.rd_16(t(y), t(adv[16]), t(w), mode,
                         peaks=peaks_from_heatmap(t(y))),
         jdisparity.rd_16(j(y), j(adv[16]), j(w), mode)),
        (disparity.rd_plain(t(y), t(adv[64]), t(w), mode),
         jdisparity.rd_plain(j(y), j(adv[64]), j(w), mode)),
    ]
    for got, ref in cases:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_upsample_bilinear_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 16, 16, K)).astype(np.float32)
    for hw in ((64, 64), (32, 32)):
        got = upsample_bilinear(torch.from_numpy(x), hw).numpy()
        ref = np.asarray(j_upsample_bilinear(jnp.asarray(x), hw))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_da_lr_and_pretrain_lr_factor():
    for step in (0, 1, 17, 1000, 123456):
        np.testing.assert_allclose(da_lr(step), float(j_da_lr(step)), rtol=1e-6)
        np.testing.assert_allclose(da_lr(step, base_lr=0.03, gamma=1e-3, decay=0.5),
                                   float(j_da_lr(step, base_lr=0.03, gamma=1e-3, decay=0.5)),
                                   rtol=1e-6)
    for epoch in range(0, 70, 3):
        assert pretrain_lr_factor(epoch) == j_pretrain_lr_factor(epoch)
    assert pretrain_lr_factor(43) == 1.0 and pretrain_lr_factor(44) == pytest.approx(0.1)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(4)
    ema = {k: rng.standard_normal((3, 4)).astype(np.float32) for k in "ab"}
    new = {k: rng.standard_normal((3, 4)).astype(np.float32) for k in "ab"}
    ref = j_ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                       {k: jnp.asarray(v) for k, v in new.items()}, 0.99)
    got = ema_update({k: torch.from_numpy(v.copy()) for k, v in ema.items()},
                     {k: torch.from_numpy(v) for k, v in new.items()}, 0.99)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


def test_ema_state_covers_params_and_bn_stats():
    model = models.MultiHeadPoseResNet(port_backbone("basic"), num_keypoints=K)
    keys = set(ema_state(model))
    assert {n for n, _ in model.named_parameters()} <= keys
    assert "backbone.bn1.running_mean" in keys and "head_adv3.last_lay.0.running_var" in keys
    assert not any(k.endswith("num_batches_tracked") for k in keys)


@pytest.mark.parametrize("share,gate,ema", [
    (True, None, None),
    (False, None, None),
    (True, 0.5, 0.99),
], ids=["shared", "unshared", "shared-gate-ema"])
def test_two_da_iterations_match_jax(da_setup, share, gate, ema, capsys):
    jmodel, variables, jax_state = da_setup
    jstate = jax_state(ema is not None)
    state = create_da_state(_port_model(variables), device="cpu", with_ema=ema is not None)
    step = make_da_train_step(state.model, share_target_features=share, conf_gate=gate,
                              ema_decay=ema, compute_metrics=True)
    jstep = _jax_step(share, gate, ema, jmodel)
    for b_s, b_t in _batches(seed=8):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b_s), jax.tree.map(jnp.asarray, b_t))
        state, metrics = step(state, _torch_batch(b_s), _torch_batch(b_t))
        for k in ("loss_s", "loss_gf", "loss_gt"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 2
    worst = _check_state(jstate, state, "after 2 iterations")
    update = _check_updates({"params": jstate.params, "batch_stats": jstate.batch_stats},
                            state.model.state_dict(), variables)
    with capsys.disabled():
        print(f"\n  DA {share=} {gate=} {ema=}: worst entry uses {worst:.3f} of the "
              f"tolerance; worst update {update:.4f} off the JAX update")


def test_da_state_from_jax_continues_a_jax_run(da_setup):
    """Iteration 1 in JAX, the state carried across by ``da_state_from_jax``
    (momentum, step and EMA included), iteration 2 in both packages."""
    jmodel, variables, jax_state = da_setup
    jstep = _jax_step(True, 0.5, 0.99, jmodel)
    (b1_s, b1_t), (b2_s, b2_t) = _batches(seed=8)
    j = lambda b: jax.tree.map(jnp.asarray, b)  # noqa: E731
    jstate, _ = jstep(jax_state(True), j(b1_s), j(b1_t))
    carried = da_state_from_jax(jax.tree.map(np.asarray, jstate),
                                models.MultiHeadPoseResNet(port_backbone("bottleneck"),
                                                           num_keypoints=K),
                                device="cpu")
    assert carried.step == 1
    buf = carried.optimizers["h"].state[carried.model.head[0].weight]["momentum_buffer"]
    assert float(buf.abs().max()) > 0
    step = make_da_train_step(carried.model, conf_gate=0.5, ema_decay=0.99)
    carried, _ = step(carried, _torch_batch(b2_s), _torch_batch(b2_t))
    jstate, _ = jstep(jstate, j(b2_s), j(b2_t))
    _check_state(jstate, carried, "continued")


def test_pretrain_step_matches_jax():
    jmodel = jmodels.PoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=K)
    variables = da_variables(jmodel, 6)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JPretrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                            opt=init_partitioned(torch_sgd(), params, J_PRETRAIN_PARTITIONS))
    model = models.PoseResNet(port_backbone("bottleneck"), num_keypoints=K)
    model.load_state_dict(state_dict_from_jax(variables))
    state = create_pretrain_state(model, device="cpu")
    b_s, _ = _batches(seed=9, n=1)[0]
    jstate, jm = jax.jit(j_make_pretrain_step(jmodel))(
        jstate, jax.tree.map(jnp.asarray, b_s), jnp.float32(0.05))
    state, m = make_pretrain_step(model)(state, _torch_batch(b_s), 0.05)
    np.testing.assert_allclose(float(m["loss_s"]), float(jm["loss_s"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["acc_s"]), float(jm["acc_s"]), rtol=1e-6)
    _worst_and_check({"params": jstate.params, "batch_stats": jstate.batch_stats},
                     model.state_dict(), "pretrain")


def test_fused_iterations_take_one_step_per_call(da_setup):
    """At the default ``steps_per_call=1`` each call is one eager step: the
    host step count and the device step tensor advance by one, and the
    metrics are that step's (no chunk mean); a K below 1 is refused.
    ``tests/test_torch_port_fused.py`` covers K > 1."""
    from dahpe_tpu_torch.data.device_store import DeviceDataStore
    from dahpe_tpu_torch.data.synthetic import SyntheticHands

    mk = dict(n=4, seed=2, image_size=(IMAGE, IMAGE), heatmap_size=(HM, HM))
    store = DeviceDataStore(SyntheticHands(split="train", **mk), device="cpu", raw_size=80,
                            verbose=False)
    _, variables, _ = da_setup
    state = create_da_state(_port_model(variables), device="cpu")
    fused = make_fused_da_iteration(state.model, store, store, B, image_size=IMAGE,
                                    heatmap_size=HM)
    for n in (1, 2):
        state, metrics, *_ = fused(state, store.generator(n), store.generator(9))
        assert state.step == int(state.step_t) == n
        assert float(metrics["lr"]) == da_lr(n - 1)
        assert metrics["pred_s"].shape == (B, K, 2)
    with pytest.raises(ValueError, match="at least 1"):
        make_fused_da_iteration(None, store, store, B, steps_per_call=0)
    with pytest.raises(ValueError, match="at least 1"):
        make_fused_pretrain_iteration(None, store, B, steps_per_call=0)


def test_peaks_feed_all_labels_once():
    """The step decodes the main head once per heatmap: rd losses given the
    decoded peaks equal those that decode ``y`` themselves."""
    rng = np.random.default_rng(12)
    y = torch.from_numpy(rng.standard_normal((2, 16, 16, K)).astype(np.float32))
    adv = torch.from_numpy(rng.standard_normal((2, 16, 16, K)).astype(np.float32))
    pk = peaks_from_heatmap(y)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(j_peaks(jnp.asarray(y.numpy()))))
    for mode in ("min", "max"):
        assert float(disparity.rd_64(y, adv, None, None, mode, peaks=pk)) == float(
            disparity.rd_64(y, adv, None, None, mode))
