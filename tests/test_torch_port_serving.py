"""PyTorch port, the serving deployment path: ``dahpe_tpu_torch.serving``
(``torch.export`` artifacts and their npz weights), ``cli.export``,
``evaluate.make_artifact_eval_step`` and ``cli.test --artifact``, on the CPU
at mini depth (a ``[1, 1, 1, 1]`` backbone, 64² frames, 16² heatmaps).

- A float artifact, saved and loaded, gives coordinates and maxvals
  ``torch.equal`` to the port's live ``make_predict_fn`` at batches 1, 3 and
  8 (it runs the same operations), and agrees with the JAX package's
  ``export_predict`` artifact on the same weights: maxvals within the
  forward's rtol 2e-3, coordinates equal wherever the heatmap's top-2 gap
  exceeds 1e-4 (elsewhere float noise may flip a near-tie, as
  ``tests/test_torch_port_eval.py`` states).
- The artifact's PCK equals the checkpoint's exactly, in the eval step and
  through the CLIs.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahpe_tpu import serving as jserving
from tests.test_torch_port_cli import _argv
from tests.test_torch_port_eval import ArraySource, _prominent
from tests.test_torch_port_models import model_pair
from tests.fixtures import make_h3d_fixture, make_rhd_fixture

from dahpe_tpu_torch import evaluate, quant, serving
from dahpe_tpu_torch.cli import export as export_cli
from dahpe_tpu_torch.cli import test as test_cli
from dahpe_tpu_torch.cli.args import build_parser
from dahpe_tpu_torch.data import DeviceDataStore, Hand21KeypointDataset
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils import fast_ckpt

IMAGE, HEATMAP = 64, 16


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes, and torch's default of one thread per core oversubscribes
    the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The same mini model in both packages, its port artifact (float32
    input, batch-polymorphic) saved to a file, and JAX's."""
    jmodel, variables, model = model_pair("bottleneck", image_size=IMAGE, seed=11)
    path = str(tmp_path_factory.mktemp("artifact") / "model.pt2")
    serving.save_predict(path, model, image_size=IMAGE, heatmap_size=HEATMAP, device="cpu")
    serving.save_variables_npz(path + ".weights.npz", model)
    jblob = jserving.export_predict(jmodel, variables, image_size=IMAGE, heatmap_size=HEATMAP)
    return jmodel, variables, model, path, jserving.load_predict(jblob)


def _frames(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
    return rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_float_artifact_matches_live_and_jax(exported, batch):
    jmodel, variables, model, path, jpredict = exported
    artifact = serving.load_predict_file(path, device="cpu")
    assert artifact.meta["batch"] is None and artifact.meta["kind"] == "float"
    weights = serving.load_artifact_weights(path + ".weights.npz")
    x = _frames(batch, seed=batch)
    coords, maxvals = artifact(weights, torch.from_numpy(x))
    live_coords, live_maxvals = evaluate.make_predict_fn(
        model, image_size=IMAGE, heatmap_size=HEATMAP, device="cpu")(x)
    assert tuple(coords.shape) == (batch, 21, 2) and tuple(maxvals.shape) == (batch, 21, 1)
    assert torch.equal(coords, live_coords) and torch.equal(maxvals, live_maxvals)

    jcoords, jmaxvals = jpredict(variables, jnp.asarray(x))
    prominent = _prominent(jmodel.apply(variables, jnp.asarray(x), train=False,
                                        gl_coeff=0.0)["y"])
    assert prominent.mean() > 0.8
    np.testing.assert_array_equal(coords.numpy()[prominent], np.asarray(jcoords)[prominent])
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(jmaxvals), rtol=2e-3, atol=2e-4)


def test_uint8_fixed_batch_artifact(exported, tmp_path):
    """The uint8-ingest variant compiles the normalization in; a fixed-batch
    artifact takes exactly its batch, and frames of another dtype raise."""
    _, _, model, _, _ = exported
    blob = serving.export_predict(model, batch_size=2, image_size=IMAGE, heatmap_size=HEATMAP,
                                  uint8_input=True, device="cpu")
    artifact = serving.load_predict(blob, device="cpu")
    assert artifact.meta["batch"] == 2 and artifact.meta["dtype"] == "uint8"
    frames = _frames(2, seed=4, dtype=np.uint8)
    coords, maxvals = artifact(serving.serving_weights(model), torch.from_numpy(frames))
    live = evaluate.make_predict_fn(model, image_size=IMAGE, heatmap_size=HEATMAP,
                                    uint8_input=True, device="cpu")(frames)
    assert torch.equal(coords, live[0]) and torch.equal(maxvals, live[1])
    with pytest.raises(ValueError, match="batch 2"):
        artifact(serving.serving_weights(model), torch.from_numpy(_frames(3, 5, np.uint8)))
    with pytest.raises(ValueError, match="uint8"):
        artifact(serving.serving_weights(model), torch.from_numpy(_frames(2, 5)))


def test_artifact_holds_no_weights(exported):
    """Weights are runtime inputs: the artifact is a fraction of the weights'
    size, and the same artifact serves other weights."""
    _, _, model, path, _ = exported
    npz = os.path.getsize(path + ".weights.npz")
    assert os.path.getsize(path) < npz / 20
    other = {k: v * 0.5 if v.is_floating_point() else v
             for k, v in serving.serving_weights(model).items()}
    artifact = serving.load_predict_file(path, device="cpu")
    x = torch.from_numpy(_frames(2, seed=9))
    assert not torch.equal(artifact(other, x)[1], artifact(serving.serving_weights(model), x)[1])


def test_int8_artifact_matches_eager_int8(exported, tmp_path):
    _, _, model, _, _ = exported
    calib = torch.from_numpy(_frames(4, seed=1))
    qtree = quant.quantize_model(model, calib)
    blob = serving.export_predict_int8(qtree, image_size=IMAGE, heatmap_size=HEATMAP,
                                       glue="float32", device="cpu")
    artifact = serving.load_predict(blob, device="cpu")
    assert artifact.meta["kind"] == "int8" and artifact.meta["glue"] == "float32"
    tree = quant.to_torch(qtree)
    eager = quant.make_int8_predict_fn(image_size=IMAGE, heatmap_size=HEATMAP,
                                       glue=torch.float32, device="cpu")
    for n in (1, 3):
        x = torch.from_numpy(_frames(n, seed=20 + n))
        got, want = artifact(tree, x), eager(tree, x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_npz_round_trip(exported, tmp_path, kind):
    _, _, model, _, _ = exported
    path = str(tmp_path / "w.npz")
    if kind == "float":
        tree = serving.serving_weights(model)
        serving.save_variables_npz(path, model)
        back = serving.load_variables_npz(path)
        assert set(back) == set(tree) and not any(k.startswith("head_adv") for k in back)
        assert all(torch.equal(back[k], tree[k]) for k in tree)
    else:
        tree = quant.quantize_model(model, torch.from_numpy(_frames(2, seed=3)))
        serving.save_quantized_npz(path, tree)
        back = serving.load_quantized_npz(path)
        assert isinstance(back["layers"], list) and isinstance(back["head"], list)
        flat = dict(serving._flat_keys(tree))
        got = dict(serving._flat_keys(back))
        assert set(flat) == set(got)
        for k, v in flat.items():
            assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_load_artifact_weights_tells_kinds_apart(exported, tmp_path):
    _, _, model, _, _ = exported
    serving.save_variables_npz(str(tmp_path / "f.npz"), model)
    qtree = quant.quantize_model(model, torch.from_numpy(_frames(2, seed=3)))
    serving.save_quantized_npz(str(tmp_path / "q.npz"), qtree)
    float_tree = serving.load_artifact_weights(str(tmp_path / "f.npz"))
    int8_tree = serving.load_artifact_weights(str(tmp_path / "q.npz"))
    assert "backbone.conv1.weight" in float_tree
    assert int8_tree["stem"]["wq"].dtype == torch.int8
    assert int8_tree["layers"][0][0]["conv1"]["sx"].ndim == 0


def test_artifact_eval_step_pck_equals_checkpoint(exported):
    """PCK of the artifact's own coordinates divided by the stride equals the
    checkpoint's eval step exactly; the loss is NaN (no heatmaps)."""
    _, _, model, path, _ = exported
    store = DeviceDataStore(ArraySource(5, IMAGE, seed=3), device="cpu", raw_size=IMAGE,
                            verbose=False)
    loader = store.eval_loader(2, heatmap_size=HEATMAP)
    dataset = Hand21KeypointDataset()
    artifact = serving.load_predict_file(path, device="cpu")
    weights = serving.load_artifact_weights(path + ".weights.npz")
    step = evaluate.make_artifact_eval_step(artifact, weights, image_size=IMAGE,
                                            heatmap_size=HEATMAP)
    live = evaluate.make_eval_step(model, device="cpu")
    batch = next(iter(loader))["batch"]
    a, b = step(batch), live(batch)
    assert torch.isnan(a["loss_per_sample"]).all()
    for key in ("acc_per_joint", "avg_acc", "cnt", "pred"):
        assert torch.equal(a[key], b[key]), key
    acc_artifact = evaluate.validate(loader, None, dataset, eval_step=step, device="cpu")
    acc_model = evaluate.validate(loader, model, dataset, device="cpu")
    assert acc_artifact == acc_model


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("fixtures")
    return (make_rhd_fixture(str(base / "rhd"), n=6, sets=("training", "evaluation")),
            make_h3d_fixture(str(base / "h3d"), n=20))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_export_cli_then_test_cli_artifact(roots, tmp_path, kind):
    """``cli.export`` from a packed checkpoint, then ``cli.test --artifact``:
    a float artifact scores the checkpoint's PCK exactly, an int8 one a real
    PCK."""
    from dahpe_tpu_torch import models

    torch.manual_seed(0)
    model = models.MultiHeadPoseResNet(models.get_backbone("resnet18"), num_keypoints=21)
    checkpoint = str(tmp_path / "ckpt")
    fast_ckpt.save_packed(checkpoint, ckpt.model_tree(model))
    out = str(tmp_path / "model.pt2")
    flags = ["--int8", "--int8-glue", "float32"] if kind == "int8" else []
    export_cli.main(export_cli.build_export_parser().parse_args(
        [checkpoint, "-o", out, "-a", "resnet18", "--image-size", "64", "--heatmap-size", "16",
         "--device", "cpu", *flags]))
    assert os.path.exists(out) and os.path.exists(out + ".weights.npz")
    by_artifact = test_cli.main(build_parser("test").parse_args(
        _argv(roots, tmp_path / "a", "--artifact", out)))
    assert 0.0 <= by_artifact["target"]["all"] <= 1.0
    if kind == "float":
        by_checkpoint = test_cli.main(build_parser("test").parse_args(
            _argv(roots, tmp_path / "c", "--checkpoint", checkpoint)))
        assert by_artifact == by_checkpoint
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_export_refuses_bf16_and_test_needs_one_source(roots, tmp_path):
    """``--int8`` refuses to take ``--bf16`` into its tree: the quantized
    weights of ``--bf16 --int8`` equal those of ``--int8`` (the JAX
    package's ``quantize_model`` calibrates from the folded float32
    weights); ``--bf16`` alone exports a float artifact
    (``tests/test_torch_port_bf16.py``). ``cli.test`` takes exactly one of
    ``--artifact`` / ``--checkpoint``."""
    from dahpe_tpu_torch import models

    torch.manual_seed(0)
    model = models.MultiHeadPoseResNet(models.get_backbone("resnet18"), num_keypoints=21)
    checkpoint = str(tmp_path / "ckpt")
    fast_ckpt.save_packed(checkpoint, ckpt.model_tree(model))
    trees = []
    for extra in ([], ["--bf16"]):
        out = str(tmp_path / f"m{len(extra)}.pt2")
        export_cli.main(export_cli.build_export_parser().parse_args(
            [checkpoint, "-o", out, "-a", "resnet18", "--image-size", str(IMAGE),
             "--heatmap-size", str(HEATMAP), "--device", "cpu", "--int8", *extra]))
        with np.load(out + ".weights.npz") as data:
            trees.append({k: data[k] for k in data.files})
    assert trees[0].keys() == trees[1].keys()
    assert all(np.array_equal(trees[0][k], trees[1][k]) for k in trees[0])
    with pytest.raises(SystemExit, match="exactly one"):
        test_cli.main(build_parser("test").parse_args(
            _argv(roots, tmp_path, "--artifact", "x", "--checkpoint", "y")))


def test_device_mismatch_raises(exported):
    """An exported program bakes its device in: a CPU artifact does not load
    for the card, and one recorded for the card does not load on the CPU."""
    _, _, model, path, _ = exported
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.load_predict_file(path, device="cuda")
    blob = serving.export_predict(model, batch_size=1, image_size=IMAGE, heatmap_size=HEATMAP,
                                  device="cpu")
    program = torch.export.load(io.BytesIO(blob))
    buf = io.BytesIO()
    meta = {"kind": "float", "device": "cuda:0", "batch": 1, "frame_shape": [IMAGE, IMAGE, 3],
            "dtype": "float32", "image_size": IMAGE, "heatmap_size": HEATMAP}
    torch.export.save(program, buf, extra_files={serving.META_FILE: json.dumps(meta)})
    with pytest.raises(ValueError, match="exported for cuda"):
        serving.load_predict(buf.getvalue(), device="cpu")
