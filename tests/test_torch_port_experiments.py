"""PyTorch port, the experiments: ``soak``, ``preempt_drill``,
``acceptance``, ``content_calibration`` and ``perf_audit`` of
``dahpe_tpu_torch/experiments/`` against the JAX package's, on the CPU at
a small size (ResNet-18 or ``micro`` at 64²/16², batch 2-4).

The soak and the drill drive the port's training CLI as subprocesses, on
the synthetic domains cut to 16 train and 8 val frames by a wrapper
(``CUT_CLI``). Tolerances: the calibration's grid point equals the JAX
package's PCK within 1e-6; ``perf_audit``'s prefixes against the JAX
package's ``make_prefix`` on the same draws as ``tests/test_torch_port_aug.py``
holds the producer: the gather and the rotation exactly, images atol 1e-3
after normalize (0.06 in pixel units before it), keypoints atol 1e-4 px,
targets within 1 ulp of XLA's ``exp``; the last prefix equals the port's
whole producer bit for bit.
"""

import json
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.data.device_store import DeviceDataStore as JDeviceDataStore
from dahpe_tpu.data.synthetic import SyntheticHands as JSyntheticHands
from dahpe_tpu.evaluate import make_eval_step as j_make_eval_step
from dahpe_tpu.experiments import perf_audit as jperf_audit
from dahpe_tpu.experiments.adaptation import _eval_target as j_eval_target
from dahpe_tpu.experiments.soak import _parse_metrics as j_parse_metrics
from tests.fixtures import make_h3d_fixture, make_rhd_fixture
from tests.test_soak_parsing import _LOG
from tests.test_torch_port_aug import _jax_draws
from tests.test_torch_port_core import _assert_gaussian_close
from tests.test_torch_port_eval import ArraySource
from tests.test_torch_port_models import jax_backbone, port_backbone, randomize_variables

from dahpe_tpu_torch import models
from dahpe_tpu_torch.data.device_store import DeviceDataStore
from dahpe_tpu_torch.data.synthetic import SyntheticHands
from dahpe_tpu_torch.experiments import content_calibration, perf_audit
from dahpe_tpu_torch.experiments.acceptance import parse_expected, run_acceptance
from dahpe_tpu_torch.experiments.preempt_drill import run_drill
from dahpe_tpu_torch.experiments.soak import _parse_metrics, run_soak
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax

# the training CLI on the synthetic domains cut to 16 train / 8 val frames
CUT_CLI = (sys.executable, "-c", textwrap.dedent("""
    import sys
    import torch
    from dahpe_tpu_torch import data
    from dahpe_tpu_torch.cli import train
    from dahpe_tpu_torch.data import synthetic

    torch.set_num_threads(2)

    def cut(base):
        class Cut(base):
            def __init__(self, root="", **kw):
                kw.setdefault("n", 8 if kw.get("split") == "test" else 16)
                super().__init__(root, **kw)
        Cut.__name__ = base.__name__
        return Cut

    data.DATASETS.update(SyntheticHandsSource=cut(synthetic.SyntheticHandsSource),
                         SyntheticHandsTarget=cut(synthetic.SyntheticHandsTarget))
    sys.exit(train.cli_main(sys.argv[1:]))
"""))
SMALL = dict(arch="resnet18", image_size=64, heatmap_size=16, batch=2, bf16=False,
             device="cpu", command=CUT_CLI, verbose=False)
IMAGE, HM = 64, 16


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def test_soak_parses_the_jax_fixture_log():
    assert _parse_metrics(_LOG) == j_parse_metrics(_LOG)


def test_soak_through_the_port_cli(tmp_path):
    """A mini soak (a pretrain epoch, 1 + 1 DA epochs over a resume): its
    logs are the port CLI's, parsed alike by the JAX package's parser, with
    the pretrain's display lines left out of the times."""
    r = run_soak(str(tmp_path), iters=2, epochs_total=2, stop_after=1, pretrain_epochs=1,
                 **SMALL)
    assert len(r["target_pck"]) == 2 and r["best_final"] >= r["best_at_stop"]
    text1 = open(tmp_path / "phase1.log").read()
    assert "Pretraining" in text1
    got = _parse_metrics(text1)
    assert got == j_parse_metrics(text1)
    da_lines = [ln for ln in text1.splitlines() if "Loss (t, false)" in ln]
    assert len(got[2]) == len(da_lines) == 1  # -i 2 at --print-freq 100: iteration 0
    records = [json.loads(ln) for ln in open(tmp_path / "logs" / "metrics.jsonl")]
    pck = [round(r["val_target"]["all"], 3) for r in records if r["kind"] == "da_epoch"]
    assert got[0] == pck[:1]


def test_preempt_drill_on_the_cpu(tmp_path):
    """SIGTERM mid-epoch: exit 0 with ``latest`` mid-epoch, the resume at the
    exact iteration, every epoch's checkpoint."""
    r = run_drill(str(tmp_path), iters=8, epochs=2, save_every=4, signal_after_iter=2,
                  print_freq=1, poll_s=0.2, timeout_s=100, **SMALL)
    assert 0 < r["stop_iter"] < 8 and r["resume_iter"] == r["stop_step"] % 8
    assert r["epochs_completed"] == 2


def test_acceptance_parse_expected_and_blocked_exit_codes(tmp_path, capsys):
    """``tests/test_acceptance.py``'s cases: 2 while the checkpoint, the
    expected score or the data is missing."""
    assert parse_expected("models/H3D_best_754.pth") == 75.4
    assert parse_expected("STB_best_750.pth") == 75.0
    assert parse_expected("pretrain_rhd.pth") is None
    assert parse_expected("model_12.pth") is None
    common = ["-t", "Hand3DStudio", "--device", "cpu"]
    assert run_acceptance([str(tmp_path / "nope_data"), *common,
                           "--checkpoint", str(tmp_path / "H3D_best_754.pth")]) == 2
    assert "BLOCKED" in capsys.readouterr().out
    weird = tmp_path / "weird.pth"
    weird.write_bytes(b"x")
    assert run_acceptance([str(tmp_path), *common, "--checkpoint", str(weird)]) == 2
    present = tmp_path / "H3D_best_754.pth"
    present.write_bytes(b"x")
    assert run_acceptance([str(tmp_path / "nope_data"), *common,
                           "--checkpoint", str(present)]) == 2


def test_acceptance_judges_a_reference_pth(tmp_path, capsys):
    """On the fixtures with a reference-format ``.pth`` of seeded weights:
    exit 0 or 1 by the file name's claim, then 0 at ``--expected`` = the
    measured PCK."""
    rhd = make_rhd_fixture(str(tmp_path / "rhd"), n=6, sets=("training", "evaluation"))
    h3d = make_h3d_fixture(str(tmp_path / "h3d"), n=20)
    torch.manual_seed(0)
    model = models.MultiHeadPoseResNet(models.resnet18(), num_keypoints=21)
    pth = str(tmp_path / "H3D_best_500.pth")
    ckpt.save_reference_pth(pth, model)
    common = [h3d, "--source_root", rhd, "-t", "Hand3DStudio", "-a", "resnet18", "-b", "2",
              "--workers", "1", "--image-size", "64", "--heatmap-size", "16", "--device", "cpu",
              "--checkpoint", pth]
    rc = run_acceptance(common + ["--log", str(tmp_path / "a1")])
    record = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("{")][-1])
    assert record["published"] == 50.0 and rc == (0 if record["accepted"] else 1)
    rc = run_acceptance(common + ["--log", str(tmp_path / "a2"), "--expected",
                                  str(record["pck_at_005_percent"])])
    assert rc == 0 and "PASS" in capsys.readouterr().out


def test_content_calibration_grid_and_a_point_from_carried_weights():
    """A 2-point grid returns the JAX package's keys; one grid point's PCK of
    a model carrying JAX weights equals the JAX package's on the same
    synthetic split."""
    r = content_calibration.run_calibration(
        arch="micro", n_train=8, n_val=8, image_size=IMAGE, heatmap_size=HM, batch=4,
        pre_iters=2, raw_size=96, shifts=(0.3,), contents=(0.0, 0.5), device="cpu",
        verbose=False)
    assert set(r) == {"source_val", "grid"}  # dahpe_tpu/experiments/content_calibration.py:126
    assert [set(p) for p in r["grid"]] == [{"shift", "content", "style", "pck"}] * 2
    assert [(p["shift"], p["content"], p["style"]) for p in r["grid"]] == [(0.3, 0.0, 0.0),
                                                                          (0.3, 0.5, 0.5)]
    assert all(0.0 <= p["pck"] <= 1.0 for p in r["grid"]) and json.dumps(r)

    jmodel = jmodels.PoseResNet(backbone=jax_backbone("basic"), num_keypoints=21)
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, jnp.zeros((1, IMAGE, IMAGE, 3)), train=False),
        jax.random.key(0))
    variables = randomize_variables(shapes, 7)
    mk = dict(n=16, seed=0, image_size=(IMAGE, IMAGE), heatmap_size=(HM, HM), domain="target",
              split="test", shift=0.3, content=0.5)
    jds = JSyntheticHands(**mk)
    jloader = JDeviceDataStore(jds, shard_samples=False, raw_size=IMAGE,
                               verbose=False).eval_loader(8, heatmap_size=HM)
    want = float(j_eval_target(jmodel, jax.tree.map(jnp.asarray, variables), jloader, jds,
                               image_size=IMAGE, heatmap_size=HM,
                               eval_step=j_make_eval_step(jmodel)))
    model = models.PoseResNet(port_backbone("basic"), num_keypoints=21)
    model.load_state_dict(state_dict_from_jax(variables))
    got = content_calibration.split_pck(model, SyntheticHands(**mk), batch=8, image_size=IMAGE,
                                        heatmap_size=HM, device="cpu")
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_perf_audit_prefixes_match_jax_and_the_producer():
    """Each prefix against the JAX package's ``perf_audit.make_prefix`` on its
    own draws, and the last prefix against the port's whole producer."""
    size, out, hm, b = 48, 32, 8, 4
    src = ArraySource(12, size, seed=6)
    key = jax.random.key(5)
    idx = np.asarray(jax.random.choice(jax.random.fold_in(key, 0), 12, shape=(b,),
                                       replace=False))
    params = _jax_draws(jax.random.fold_in(key, 1), b, size=size, out_size=out)
    store = DeviceDataStore(src, device="cpu", raw_size=size, verbose=False)
    arrays = (jnp.asarray(src.images), jnp.asarray(src.kps), jnp.asarray(src.vis),
              jnp.tile(jnp.eye(3), (12, 1, 1)))
    t_idx = torch.tensor(idx, dtype=torch.int64)
    pixel_atol = 1e-3 * 255 * 0.229
    for name in perf_audit.STAGES:
        want, want_aux = jperf_audit.make_prefix(name, b, out, 180.0, (0.6, 1.3), "matmul", hm,
                                                 2.0)(*arrays, key)
        got, got_aux = perf_audit.make_prefix(name, store, image_size=out,
                                              heatmap_size=hm)(t_idx, params)
        if name in ("crop", "jitter", "blur"):
            got = got.permute(0, 2, 3, 1)  # channels-first until the normalize
        if name in ("gather", "rotate"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        else:
            atol = pixel_atol if name in ("crop", "jitter", "blur") else 1e-3
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, err_msg=name)
        if name == "targets":
            _assert_gaussian_close(got_aux[..., 0].numpy(), want_aux)
        else:
            np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), atol=1e-4,
                                       err_msg=name)
    whole = store.train_batch_from(t_idx, params, image_size=out, heatmap_size=hm)
    last = perf_audit.make_prefix("targets", store, image_size=out, heatmap_size=hm)(t_idx,
                                                                                    params)
    assert torch.equal(last[0], whole["image"]) and torch.equal(last[1], whole["target"])
    # the drawn form is the store's producer on one generator
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = perf_audit.drawn(perf_audit.make_prefix("targets", store, image_size=out,
                                                heatmap_size=hm), store, b)(g1)
    bb = store.traced_batch_fn(b, image_size=out, heatmap_size=hm)(g2)
    assert torch.equal(a[0], bb["image"]) and torch.equal(a[1], bb["target"])
    with pytest.raises(ValueError, match="unknown stage"):
        perf_audit.make_prefix("warp", store)


def test_perf_audit_refuses_to_time_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        perf_audit.main(batch=2, raw=48, out_size=32, n_store=4)

