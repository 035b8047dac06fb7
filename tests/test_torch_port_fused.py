"""PyTorch port, ``steps_per_call = K``: the device step count, lr and GL
coefficient, the K-iteration call and the CLI's chunk rules, on the CPU.

- The device forms of the schedules (``train.optim.StepTable`` over
  ``da_lr``, ``ops.gradient_scale.warm_start_coeff`` on a step tensor)
  against the JAX package's ``da_lr`` / ``warm_start_coeff`` at every step
  of a run: the lr bit for bit, λ within 4 float32 ulps of its top value
  ``hi`` (the two exps differ in their last bit, and λ is a difference of
  two terms near ``hi``; ROADMAP queue 3 lists the delta).
- Three DA steps and three pretrain steps, the step count, lr and λ held as
  tensors on the device (the CPU here) and fed JAX's batches, against three
  steps of ``make_da_train_step`` / ``make_pretrain_step`` at the DA parity
  tolerance (rtol 5e-3 / atol 5e-5, ``tests/test_da_parity.py:221``).
- A ``steps_per_call=3`` call against three single calls
  (``tests/test_fused.py``'s tolerances: chunk-mean loss rtol 1e-3, state
  rtol 0.05 / atol 5e-4), and the same draws (generator states
  ``torch.equal``, batches equal).
- The CLI's rules for K > 1 (the JAX package's ``cli/train.py:97-125`` and
  ``:561-566``), and a chunked ``--max-steps`` + ``--resume`` against a
  straight run on the RHD/H3D fixtures.

On the card the K-iteration call is a CUDA graph replayed K times; the
replay is held to eager execution by ``chip_smoke.py`` phase 8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.ops.gradient_scale import warm_start_coeff as j_warm_start_coeff
from dahpe_tpu.train import DATrainState as JDATrainState
from dahpe_tpu.train import PretrainState as JPretrainState
from dahpe_tpu.train import make_da_train_step as j_make_da_train_step
from dahpe_tpu.train import make_pretrain_step as j_make_pretrain_step
from dahpe_tpu.train.optim import da_lr as j_da_lr
from dahpe_tpu.train.optim import DA_PARTITIONS as J_DA_PARTITIONS
from dahpe_tpu.train.optim import init_partitioned, torch_sgd
from dahpe_tpu.train.pretrain import PRETRAIN_PARTITIONS as J_PRETRAIN_PARTITIONS
from tests.fixtures import make_h3d_fixture, make_rhd_fixture
from tests.test_torch_port_models import jax_backbone, port_backbone
from tests.test_torch_port_train import (
    _batches,
    _check_state,
    _torch_batch,
    _worst_and_check,
    da_variables,
)

from dahpe_tpu_torch import models
from dahpe_tpu_torch.cli import common
from dahpe_tpu_torch.cli import train as train_cli
from dahpe_tpu_torch.cli.args import build_parser
from dahpe_tpu_torch.data.device_store import DeviceDataStore
from dahpe_tpu_torch.data.synthetic import SyntheticHands
from dahpe_tpu_torch.ops.gradient_scale import warm_start_coeff
from dahpe_tpu_torch.train import (
    create_da_state,
    create_pretrain_state,
    make_da_train_step,
    make_fused_da_iteration,
    make_fused_pretrain_iteration,
    make_pretrain_step,
)
from dahpe_tpu_torch.train.optim import StepTable, da_lr
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils import fast_ckpt
from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax

K, IMAGE, HM, B = 21, 64, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("base_lr,gamma,decay,gl_hi,gl_iters", [
    (0.01, 1e-4, 0.75, 0.1, 1000), (0.03, 1e-3, 0.5, 0.2, 300)],
    ids=["defaults", "other"])
def test_device_schedules_equal_jax_at_every_step(base_lr, gamma, decay, gl_hi, gl_iters):
    """The first 20,480 steps of a run (41 epochs of the CLI's default 500
    iterations), each read at a 0-d int64 step tensor as the DA step reads
    it."""
    steps = 20480
    table = StepTable(lambda i: da_lr(i, base_lr=base_lr, gamma=gamma, decay=decay))
    assert table.cover(steps, "cpu") and not table.cover(steps, "cpu")
    step_t = torch.zeros((), dtype=torch.int64)
    lr, lam = np.empty(steps, np.float32), np.empty(steps, np.float32)
    for i in range(steps):
        step_t.fill_(i)
        lr[i] = table(step_t)
        lam[i] = warm_start_coeff(step_t, hi=gl_hi, max_iters=gl_iters)
    all_steps = jnp.arange(steps)
    j_lr = np.asarray(j_da_lr(all_steps, base_lr=base_lr, gamma=gamma, decay=decay))
    j_lam = np.asarray(j_warm_start_coeff(all_steps, hi=gl_hi, max_iters=gl_iters))
    np.testing.assert_array_equal(lr, j_lr)
    np.testing.assert_array_equal(lr, [np.float32(da_lr(i, base_lr=base_lr, gamma=gamma,
                                                        decay=decay)) for i in range(steps)])
    np.testing.assert_allclose(lam, j_lam, rtol=0, atol=4 * np.spacing(np.float32(gl_hi)))


def test_three_da_steps_match_jax():
    """Three DA steps (micro backbone, shared target features, confidence
    gate, EMA) with the step count, lr and λ as tensors: the state within
    the DA parity tolerance of three JAX steps, the step tensor advanced in
    place, and the lr and λ metrics equal to the JAX schedules' values."""
    jmodel = jmodels.MultiHeadPoseResNet(backbone=jax_backbone("basic"), num_keypoints=K)
    variables = da_variables(jmodel, 1, gl_coeff=0.0)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    jstate = JDATrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt=init_partitioned(torch_sgd(), params, J_DA_PARTITIONS),
                           ema_params=params, ema_batch_stats=stats)
    model = models.MultiHeadPoseResNet(port_backbone("basic"), num_keypoints=K)
    model.load_state_dict(state_dict_from_jax(variables))
    state = create_da_state(model, device="cpu", with_ema=True)
    step = make_da_train_step(model, conf_gate=0.5, ema_decay=0.99)
    jstep = jax.jit(j_make_da_train_step(jmodel, compute_metrics=False, conf_gate=0.5,
                                         ema_decay=0.99))
    for i, (b_s, b_t) in enumerate(_batches(seed=11, n=3)):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b_s),
                           jax.tree.map(jnp.asarray, b_t))
        state, m = step(state, _torch_batch(b_s), _torch_batch(b_t))
        assert isinstance(m["lr"], torch.Tensor) and isinstance(m["gl_coeff"], torch.Tensor)
        assert m["lr"].dtype == m["gl_coeff"].dtype == torch.float32
        assert float(m["lr"]) == float(j_da_lr(i))
        np.testing.assert_allclose(m["gl_coeff"].numpy(), np.asarray(j_warm_start_coeff(i)),
                                   rtol=0, atol=4 * np.spacing(np.float32(0.1)))
        for name in ("loss_s", "loss_gf", "loss_gt"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-4,
                                       err_msg=name)
    assert state.step == int(jstate.step) == 3
    assert state.step_t.dtype == torch.int64 and int(state.step_t) == 3
    _check_state(jstate, state, "after 3 iterations")


def test_three_pretrain_steps_match_jax():
    """Three pretrain steps on a 0-d lr tensor (the device form a chunk
    reads) against three JAX steps on its float32 lr."""
    jmodel = jmodels.PoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=K)
    variables = da_variables(jmodel, 6)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JPretrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                            opt=init_partitioned(torch_sgd(), params, J_PRETRAIN_PARTITIONS))
    model = models.PoseResNet(port_backbone("bottleneck"), num_keypoints=K)
    model.load_state_dict(state_dict_from_jax(variables))
    state = create_pretrain_state(model, device="cpu")
    jstep, step = jax.jit(j_make_pretrain_step(jmodel)), make_pretrain_step(model)
    lr = torch.tensor(0.05, dtype=torch.float32)
    for b_s, _ in _batches(seed=12, n=3):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b_s), jnp.float32(0.05))
        state, m = step(state, _torch_batch(b_s), lr)
        np.testing.assert_allclose(float(m["loss_s"]), float(jm["loss_s"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 3
    _worst_and_check({"params": jstate.params, "batch_stats": jstate.batch_stats},
                     model.state_dict(), "pretrain after 3 steps")


@pytest.fixture(scope="module")
def stores():
    """Two small synthetic stores on the CPU (96² crops, 8 frames each)."""
    mk = dict(n=8, seed=5, image_size=(IMAGE, IMAGE), heatmap_size=(HM, HM))
    return [DeviceDataStore(SyntheticHands(domain=d, split="train", **mk), device="cpu",
                            raw_size=96, verbose=False) for d in ("source", "target")]


def _recording(store, drawn):
    """``store`` with its producer wrapped to record every batch it makes."""
    real = store.traced_batch_fn

    class Recording:
        device = store.device

        def traced_batch_fn(self, *a, **kw):
            produce = real(*a, **kw)

            def recorded(gen):
                batch = produce(gen)
                drawn.append(batch["image"].clone())
                return batch
            return recorded
    return Recording()


_RUNS = {}


def _run(kind, stores, k, calls):
    """``calls`` calls of a fresh ``steps_per_call=k`` iteration from seeded
    weights and generators: the state, each call's metrics, the generators
    and every drawn batch image (cached: two tests read each run)."""
    if (kind, k, calls) in _RUNS:
        return _RUNS[kind, k, calls]
    torch.manual_seed(3)
    drawn = []
    src, tgt = (_recording(s, drawn) for s in stores)
    cfg = dict(image_size=IMAGE, heatmap_size=HM, rotation=30.0, steps_per_call=k)
    gens = [stores[0].generator(7), stores[1].generator(8)]
    metrics = []
    if kind == "da":
        model = models.MultiHeadPoseResNet(port_backbone("bottleneck"), num_keypoints=K)
        state = create_da_state(model, device="cpu", with_ema=True)
        fused = make_fused_da_iteration(model, src, tgt, B, ema_decay=0.99, conf_gate=0.5,
                                        **cfg)
        for _ in range(calls):
            state, m, *_ = fused(state, *gens)
            metrics.append(m)
    else:
        model = models.PoseResNet(port_backbone("bottleneck"), num_keypoints=K)
        state = create_pretrain_state(model, device="cpu")
        fused = make_fused_pretrain_iteration(model, src, B, **cfg)
        for _ in range(calls):
            state, m, _ = fused(state, gens[0], 0.01)
            metrics.append(m)
    _RUNS[kind, k, calls] = state, metrics, gens, drawn
    return _RUNS[kind, k, calls]


@pytest.mark.parametrize("kind", ["da", "pretrain"])
def test_chunk_of_three_equals_three_single_calls(stores, kind):
    """One ``steps_per_call=3`` call leaves the state three single calls
    leave and returns the mean of their metrics."""
    state_1, single, _, _ = _run(kind, stores, 1, 3)
    state_k, (m_k,), _, _ = _run(kind, stores, 3, 1)
    assert state_k.step == state_1.step == 3
    for name, v in m_k.items():
        mean = sum(m[name] for m in single) / 3
        np.testing.assert_allclose(v.numpy(), mean.numpy(), rtol=1e-3, err_msg=name)
    for (name, a), b in zip(state_1.model.state_dict().items(),
                            state_k.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.05, atol=5e-4, err_msg=name)
    if kind == "da":
        assert int(state_k.step_t) == 3
        for name, a in state_1.ema.items():
            np.testing.assert_allclose(state_k.ema[name].numpy(), a.numpy(), rtol=0.05,
                                       atol=5e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["da", "pretrain"])
def test_chunk_draws_what_single_calls_draw(stores, kind):
    """A ``steps_per_call=3`` call draws the batches of three single calls,
    in order, and leaves the generators in the same states."""
    _, _, gens_1, drawn_1 = _run(kind, stores, 1, 3)
    _, _, gens_k, drawn_k = _run(kind, stores, 3, 1)
    assert len(drawn_k) == len(drawn_1) == (6 if kind == "da" else 3)
    assert all(torch.equal(a, b) for a, b in zip(drawn_1, drawn_k))
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(gens_1, gens_k))


def test_chunk_size_below_one_is_refused(stores):
    with pytest.raises(ValueError, match="at least 1"):
        make_fused_da_iteration(None, stores[0], stores[1], B, steps_per_call=0)
    with pytest.raises(ValueError, match="at least 1"):
        make_fused_pretrain_iteration(None, stores[0], B, steps_per_call=-2)


def _args(*flags):
    return build_parser("train").parse_args(["unused", "-s", "SyntheticHandsSource", "-t",
                                             "SyntheticHandsTarget", "--device", "cpu",
                                             *flags])


@pytest.mark.parametrize("flags,message", [
    (["--steps-per-call", "2"], "needs --device-store"),
    (["--steps-per-call", "4", "--device-store", "-i", "8", "--print-freq", "6"],
     "--print-freq=6 must be multiples of K"),
    (["--steps-per-call", "4", "--device-store", "-i", "10", "--save-every", "3",
      "--max-steps", "12", "--print-freq", "4"],
     "--iters-per-epoch=10, --save-every=3 must be multiples of K"),
], ids=["no device store", "print freq", "epoch and save"])
def test_chunked_cadences_are_checked(flags, message):
    """K > 1 needs ``--device-store`` and cadences that are multiples of K;
    a conforming K passes."""
    with pytest.raises(SystemExit, match=message):
        common.validate_steps_per_call(_args(*flags))
    ok = _args("--steps-per-call", "4", "--device-store", "-i", "8", "--print-freq", "4",
               "--save-every", "8", "--max-steps", "16")
    assert common.validate_steps_per_call(ok) == 4


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("fused_cli")
    return (make_rhd_fixture(str(base / "rhd"), n=6, sets=("training", "evaluation")),
            make_h3d_fixture(str(base / "h3d"), n=20))


def _cli_argv(roots, log, *extra, iters=4):
    """The training CLI on the RHD/H3D fixtures, ResNet-18 at 64², batch 2,
    ``iters``-iteration epochs, ``--device-store --steps-per-call 2``."""
    rhd, h3d = roots
    return [h3d, "--source_root", rhd, "-t", "Hand3DStudio", "-a", "resnet18", "-b", "2",
            "-i", str(iters), "--print-freq", "2", "--workers", "1", "--image-size", "64",
            "--heatmap-size", "16", "--device", "cpu", "--log", str(log),
            "--device-store", "--steps-per-call", "2", *extra]


def test_chunked_cli_resume_is_the_straight_run(roots, tmp_path):
    """With K = 2 and 2-iteration epochs, ``--max-steps 2`` then
    ``--resume`` to 4 (across an epoch boundary) leaves the checkpoint and
    generators of a straight run to 4 (which validates between its epochs),
    bit for bit on the CPU."""
    common = ("--with-ema", "--pretrain-epochs", "0", "--epochs", "2")
    a, b = tmp_path / "a", tmp_path / "b"
    assert train_cli.cli_main(_cli_argv(roots, a, *common, "--max-steps", "2", iters=2)) == 0
    latest = str(a / "checkpoints" / "latest")
    assert train_cli.cli_main(_cli_argv(roots, a, *common, "--max-steps", "4", "--resume",
                                        latest, iters=2)) == 0
    assert train_cli.cli_main(_cli_argv(roots, b, *common, "--max-steps", "4", iters=2)) == 0
    resumed = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(latest))
    straight = fast_ckpt.flatten_tree(
        fast_ckpt.load_packed_tree(str(b / "checkpoints" / "latest")))
    assert int(dict(resumed)[("step",)]) == 4
    assert [p for p, _ in resumed] == [p for p, _ in straight]
    for (path, x), (_, y) in zip(resumed, straight):
        assert torch.equal(x, y), path
    aux_a, aux_b = ckpt.load_aux(latest), ckpt.load_aux(str(b / "checkpoints" / "latest"))
    for key in ("key_s", "key_t"):
        np.testing.assert_array_equal(aux_a[key], aux_b[key])


def test_chunked_resume_off_a_boundary_is_refused(roots, tmp_path):
    """A ``--resume`` checkpoint at step 3 of 4-iteration epochs cannot
    continue with K = 2: it stops between two chunks."""
    argv = _cli_argv(roots, tmp_path / "log")
    state = create_da_state(common.build_model(build_parser("train").parse_args(argv)),
                            device="cpu")
    state.step = 3
    path = str(tmp_path / "step3")
    ckpt.save_state(path, state)
    with pytest.raises(SystemExit, match="not a --steps-per-call 2 chunk boundary"):
        train_cli.main(build_parser("train").parse_args(argv + ["--resume", path]))
