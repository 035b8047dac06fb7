"""PyTorch port, the training and evaluation CLIs end to end on the CPU
(``--device cpu``) at a small size: ResNet-18, 64² frames, 16² heatmaps,
batch 2, on the RHD and H3D fixtures of ``tests/fixtures.py``.

They cover the three input modes (``pil``, ``raw`` = ``--device-aug`` and
``--device-store``), warm starts from the JAX package's packed checkpoint
and from a reference ``.pth``, ``--max-steps`` then ``--resume`` against a
straight run (bit-identical on the CPU), the SIGTERM drain (exit 0), the
NaN watchdog (exit 3), ``--bf16`` and the ``--debug`` drawings (pixel for
pixel the JAX package's), the flag combinations that are refused, and the
help texts. ``--host-warp`` is ``tests/test_torch_port_host_warp.py``'s. The card runs the same CLI at full width in ``chip_smoke.py``
phases 6, 8b and 9d.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.utils import checkpoint as jckpt
from dahpe_tpu.utils import fast_ckpt as jfast_ckpt
from tests.conftest import REPO_ROOT
from tests.fixtures import make_h3d_fixture, make_rhd_fixture
from tests.test_torch_port_models import randomize_variables

from dahpe_tpu_torch.cli import test as test_cli
from dahpe_tpu_torch.cli import train as train_cli
from dahpe_tpu_torch.cli.args import build_parser
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils import fast_ckpt


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes, and torch's default of one thread per core oversubscribes
    the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_checkpoints(tmp_path):
    """A run's checkpoints take hundreds of MB: remove them after the test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    return (make_rhd_fixture(str(base / "rhd"), n=6, sets=("training", "evaluation")),
            make_h3d_fixture(str(base / "h3d"), n=20))


def _argv(roots, log, *extra):
    rhd, h3d = roots
    return [h3d, "--source_root", rhd, "-t", "Hand3DStudio", "-a", "resnet18", "-b", "2",
            "-i", "2", "--workers", "2", "--print-freq", "1", "--image-size", "64",
            "--heatmap-size", "16", "--device", "cpu", "--log", str(log), *extra]


def _metrics(log):
    return [json.loads(line) for line in open(os.path.join(log, "metrics.jsonl"))]


def _jax_pretrain_checkpoint(path):
    """A JAX-package ``PoseResNet(resnet18)`` pretrain checkpoint."""
    jmodel = jmodels.PoseResNet(backbone=jmodels.get_backbone("resnet18"), num_keypoints=21)
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.key(0))
    variables = randomize_variables(shapes, 1)
    jfast_ckpt.save_packed(path, variables)
    return variables


@pytest.mark.parametrize("mode", ["pil", "raw", "device-store"])
def test_train_cli_end_to_end_then_test_cli(roots, tmp_path, mode):
    """Pretrain epoch + DA epoch with validation, checkpoints and metrics,
    then ``cli.test`` on ``best`` reproduces the epoch's target PCK."""
    log = tmp_path / "logs"
    extra = {"pil": [], "raw": ["--device-aug"],
             "device-store": ["--device-store", "--with-ema", "--decoded-cache",
                              str(tmp_path / "cache")]}[mode]
    assert train_cli.cli_main(_argv(roots, log, "--pretrain-epochs", "1", "--epochs", "1",
                                    *extra)) == 0
    ckdir = log / "checkpoints"
    names = {"pretrain", "0", "best", "latest"} | ({"model_ema"} if mode == "device-store" else set())
    assert names <= set(os.listdir(ckdir))
    assert all(fast_ckpt.is_packed(str(ckdir / n)) for n in names)
    records = _metrics(log)
    assert [r["kind"] for r in records] == ["pretrain_epoch", "da_epoch"]
    da = records[1]
    assert da["step"] == 2.0 and da["val_target"].keys() >= {"all", "MCP", "fingertip"}
    assert all(np.isfinite(da[k]) for k in ("loss_s", "loss_gf", "loss_gt"))
    assert ("val_target_ema" in da) == (mode == "device-store")
    assert ckpt.load_aux(str(ckdir / "best"))["best_acc"] == da["best_target"]
    store = ["--device-store"] if mode == "device-store" else []
    targs = build_parser("test").parse_args(_argv(roots, tmp_path / "test", *store,
                                                  "--checkpoint", str(ckdir / "best")))
    scores = test_cli.main(targs)
    assert scores["target"]["all"] == pytest.approx(da["val_target"]["all"], abs=1e-6)


@pytest.mark.parametrize("kind", ["jax-packed", "reference-pth"])
def test_pretrain_warm_start_from_the_jax_package(roots, tmp_path, kind):
    """``--pretrain`` takes the JAX package's packed checkpoint or a
    reference ``.pth``; the DA model's backbone starts from it."""
    from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax

    variables = _jax_pretrain_checkpoint(str(tmp_path / "jax_pretrain"))
    path = str(tmp_path / "jax_pretrain")
    if kind == "reference-pth":
        path = str(tmp_path / "pretrain.pth")
        jckpt.save_reference_pth(path, variables)
    log = tmp_path / "logs"
    assert train_cli.cli_main(_argv(roots, log, "--pretrain", path, "--epochs", "1",
                                    "--max-steps", "1", "--lr", "0")) == 0
    # lr 0: the weights stay the warm start (weight decay is scaled by lr too)
    saved = fast_ckpt.load_packed_tree(str(log / "checkpoints" / "latest"))["model"]
    want = state_dict_from_jax(variables)
    for key in ("backbone.conv1.weight", "backbone.layer4.1.conv2.weight", "upsampling.0.weight"):
        assert torch.equal(saved[key], want[key]), key


def test_max_steps_then_resume_is_the_straight_run(roots, tmp_path):
    """``--max-steps 3`` then ``--resume latest`` to 5 gives the same state,
    EMA, momentum, step and sampling generators as a straight run to 5 (the
    resume crosses an epoch boundary with its validation)."""
    common = ("--device-store", "--with-ema", "--pretrain-epochs", "0", "--epochs", "3")
    a, b = tmp_path / "a", tmp_path / "b"
    assert train_cli.cli_main(_argv(roots, a, *common, "--max-steps", "3")) == 0
    latest = str(a / "checkpoints" / "latest")
    assert int(fast_ckpt.load_packed_tree(latest)["step"]) == 3
    assert train_cli.cli_main(_argv(roots, a, *common, "--max-steps", "5", "--resume",
                                    latest)) == 0
    assert train_cli.cli_main(_argv(roots, b, *common, "--max-steps", "5")) == 0
    resumed = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(latest))
    straight = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(str(b / "checkpoints" / "latest")))
    assert [p for p, _ in resumed] == [p for p, _ in straight]
    assert {p[0] for p, _ in resumed} == {"model", "opt", "step", "ema"}
    for (path, x), (_, y) in zip(resumed, straight):
        assert torch.equal(x, y), path
    aux_a, aux_b = ckpt.load_aux(latest), ckpt.load_aux(str(b / "checkpoints" / "latest"))
    for key in ("key_s", "key_t", "best_acc"):
        np.testing.assert_array_equal(aux_a[key], aux_b[key])


def test_keep_checkpoints_and_conf_gate(roots, tmp_path):
    """``--keep-checkpoints 1`` leaves only the newest epoch directory (named
    checkpoints stay); ``--conf-gate`` trains with finite losses."""
    log = tmp_path / "logs"
    assert train_cli.cli_main(_argv(roots, log, "--device-store", "--pretrain-epochs", "0",
                                    "--epochs", "3", "-i", "1", "--keep-checkpoints", "1",
                                    "--conf-gate", "0.5")) == 0
    names = set(os.listdir(log / "checkpoints"))
    assert {"2", "best", "latest"} <= names and not names & {"0", "1", "0_aux.npz", "1_aux.npz"}
    assert all(np.isfinite(r[k]) for r in _metrics(log) for k in ("loss_s", "loss_gf", "loss_gt"))


def test_sigterm_drains_and_exits_zero(roots, tmp_path):
    """``python -m dahpe_tpu_torch.cli.train --device cpu``: a SIGTERM in the
    DA loop finishes the iteration, saves ``latest`` and exits 0."""
    log = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "dahpe_tpu_torch.cli.train",
         *_argv(roots, log, "--device-store", "--pretrain-epochs", "0", "--epochs", "1000")],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = []
    try:
        for text in proc.stdout:
            out.append(text)
            if text.startswith("Start regression domain adaptation"):
                proc.send_signal(signal.SIGTERM)
                break
        out += proc.stdout.readlines()
        assert proc.wait(timeout=300) == 0, "".join(out)
    finally:
        proc.kill()
    text = "".join(out)
    assert "signal 15" in text and "continue with --resume" in text
    step = int(fast_ckpt.load_packed_tree(str(log / "checkpoints" / "latest"))["step"])
    assert step >= 1


def test_nan_watchdog_exits_3_and_keeps_latest_finite(roots, tmp_path, monkeypatch):
    """A diverged iteration stops the run with exit 3; the poisoned state
    goes to ``nan_abort`` and ``latest`` keeps the last finite state."""
    real = train_cli.make_fused_da_iteration

    def poisoned(model, *args, **kwargs):
        call = real(model, *args, **kwargs)

        def run(state, *gens):
            if state.step == 2:  # the third iteration starts from NaN weights
                with torch.no_grad():
                    next(model.head.parameters()).fill_(float("nan"))
            return call(state, *gens)
        return run

    monkeypatch.setattr(train_cli, "make_fused_da_iteration", poisoned)
    log = tmp_path / "logs"
    rc = train_cli.cli_main(_argv(roots, log, "--device-store", "--pretrain-epochs", "0",
                                  "--epochs", "3", "--save-every", "1"))
    assert rc == 3
    ckdir = log / "checkpoints"
    latest = fast_ckpt.load_packed_tree(str(ckdir / "latest"))
    assert int(latest["step"]) == 2
    assert all(torch.isfinite(v).all() for v in latest["model"].values() if v.is_floating_point())
    abort = fast_ckpt.load_packed_tree(str(ckdir / "nan_abort"))
    assert not all(torch.isfinite(v).all() for v in abort["model"].values()
                   if v.is_floating_point())


@pytest.mark.parametrize("flags,item", [
    (["--steps-per-call", "2"], "needs --device-store"),
    (["--steps-per-call", "0"], "at least 1"),
    (["--device-store", "--steps-per-call", "2", "--debug"], "without --debug"),
])
def test_unported_flags_are_refused(roots, tmp_path, flags, item):
    """Refused before anything is built, naming the rule broken; nothing is
    silently ignored."""
    with pytest.raises(SystemExit, match=item):
        train_cli.cli_main(_argv(roots, tmp_path / "logs", *flags))
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("phase", ["train", "test"])
def test_no_flag_help_says_not_ported(phase):
    """Every flag the parser accepts runs: no help text still calls its
    path unported (``--multihost`` and ``--host-warp`` once did)."""
    stale = [a.option_strings for a in build_parser(phase)._actions
             if "not ported" in (a.help or "")]
    assert not stale, stale


def _drawings(log) -> set[str]:
    root = log / "visualize"
    return {os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root)
            for f in files}


@pytest.mark.parametrize("flag", ["--bf16", "--debug"])
def test_formerly_refused_flags_run(roots, tmp_path, flag):
    """``--bf16`` and ``--debug``, refused until they were ported, run a
    pretrain and a DA epoch on the PIL path: finite losses, and with
    ``--debug`` the first source and target image of each printed batch
    and the target validation's drawn into ``visualize/<epoch>/``; without
    it nothing is drawn."""
    log = tmp_path / "logs"
    assert train_cli.cli_main(_argv(roots, log, "--pretrain-epochs", "1", "--epochs", "1",
                                    "--print-freq", "2", flag)) == 0
    (da,) = [r for r in _metrics(log) if r["kind"] == "da_epoch"]
    assert all(np.isfinite(da[k]) for k in ("loss_s", "loss_gf", "loss_gt"))
    want = {"0/source_0_pred.jpg", "0/target_0_pred.jpg", "0/val_0_pred.jpg",
            "0/val_0_label.jpg"}
    assert _drawings(log) == (want if flag == "--debug" else set())


def test_debug_with_device_store_and_test_cli(roots, tmp_path):
    """``--device-store --debug`` runs one iteration a call, whose batches
    the fused call returns, and draws the printed batches; the device-resident
    validation is not drawn. ``cli.test --debug`` draws the target split's
    printed host batches."""
    log = tmp_path / "logs"
    assert train_cli.cli_main(_argv(roots, log, "--device-store", "--debug",
                                    "--pretrain-epochs", "0", "--epochs", "1")) == 0
    assert _drawings(log) == {f"0/{d}_{i}_pred.jpg" for d in ("source", "target")
                              for i in (0, 1)}
    args = build_parser("test").parse_args(_argv(
        roots, tmp_path / "test", "--debug", "--checkpoint",
        str(log / "checkpoints" / "latest")))
    test_cli.main(args)
    n = len(test_cli.build_val_loader(args, test_cli.build_datasets(args, val_only=True)[3]))
    assert _drawings(tmp_path / "test") == {f"val_{i}_{k}.jpg" for i in range(n)
                                            for k in ("pred", "label")}


@pytest.mark.parametrize("kind", ["skeleton", "heatmap"])
def test_drawings_match_jax(tmp_path, kind):
    """``KeypointDataset.visualize`` and ``utils.visualize.visualize_heatmap``
    write the JAX package's pixels (cv2 draws both)."""
    import cv2

    from dahpe_tpu.data.datasets.base import Hand21KeypointDataset as JHand21
    from dahpe_tpu.utils.visualize import visualize_heatmap as j_visualize_heatmap

    from dahpe_tpu_torch.data import Hand21KeypointDataset
    from dahpe_tpu_torch.utils.visualize import visualize_heatmap

    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    if kind == "skeleton":
        kps = rng.uniform(-4, 68, (21, 2)).astype(np.float32)
        Hand21KeypointDataset().visualize(image, kps, str(tmp_path / "port.png"))
        JHand21("unused", []).visualize(image, kps, str(tmp_path / "jax.png"))
        names = ["port.png"]
    else:
        hm = rng.uniform(-0.2, 1.2, (16, 16, 3)).astype(np.float32)
        visualize_heatmap(image, hm, str(tmp_path / "port_{}.png"))
        j_visualize_heatmap(image, hm, str(tmp_path / "jax_{}.png"))
        names = [f"port_{j}.png" for j in range(3)]
    for name in names:
        got = cv2.imread(str(tmp_path / name))
        assert got is not None and got.std() > 0, name
        assert np.array_equal(got, cv2.imread(str(tmp_path / name.replace("port", "jax"))))


def test_test_cli_refuses_artifacts_and_needs_a_checkpoint(roots, tmp_path):
    """An artifact together with a checkpoint is refused, and so is neither:
    exactly one is evaluated (``tests/test_torch_port_serving.py`` runs
    ``--artifact`` alone)."""
    with pytest.raises(SystemExit, match="exactly one"):
        test_cli.main(build_parser("test").parse_args(
            _argv(roots, tmp_path, "--artifact", "x", "--checkpoint", "y")))
    with pytest.raises(SystemExit, match="--checkpoint / --artifact"):
        test_cli.main(build_parser("test").parse_args(_argv(roots, tmp_path)))


def test_entry_points_target_the_card_by_default(roots, tmp_path):
    """Without ``--device`` the CLIs run on ``cuda``; the CPU is used only
    when asked for."""
    rhd, h3d = roots
    for phase in ("train", "test"):
        args = build_parser(phase).parse_args([h3d, "-t", "Hand3DStudio"])
        assert args.device == "cuda"
    if not torch.cuda.is_available():
        # no silent fallback: the run fails at its first tensor on the card
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            train_cli.cli_main([h3d, "--source_root", rhd, "-t", "Hand3DStudio", "-a",
                                "resnet18", "-b", "2", "--workers", "1", "--device-store",
                                "--pretrain-epochs", "0", "--log", str(tmp_path / "logs")])
