"""PyTorch port, serving and validation: ``dahpe_tpu_torch.evaluate`` and
the device eval loader against ``dahpe_tpu`` on the same weights and data.

Decoded coordinates must be equal wherever the top-2 gap of the heatmap is
> 1e-4 (random-weight heatmaps are near-flat in places, where sub-tolerance
float noise may legitimately flip a tie, as ``tests/test_full_model_parity.py``
states); per-joint PCK and the per-group PCK dict are exact. The eval
loader's images are within 1e-6 (normalize order), its targets as in
``tests/test_torch_port_core.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahpe_tpu import evaluate as jevaluate
from dahpe_tpu.core.heatmap import generate_target as j_generate_target
from dahpe_tpu.data.datasets.base import Hand21KeypointDataset as JHand21
from dahpe_tpu.data.device_store import DeviceDataStore as JDeviceDataStore
from tests.test_torch_port_models import model_pair

from dahpe_tpu_torch import evaluate
from dahpe_tpu_torch.data import DeviceDataStore, Hand21KeypointDataset

IMAGE, HEATMAP = 64, 16


@pytest.fixture(scope="module")
def pair():
    return model_pair("bottleneck", image_size=IMAGE, seed=11)


def _prominent(y):
    """(B, K) mask of joints whose heatmap max beats the runner-up by 1e-4."""
    b, h, w, k = y.shape
    top2 = np.sort(np.asarray(y).reshape(b, h * w, k), axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > 1e-4


class ArraySource:
    """An in-memory split in the store's ``fetch_raw`` protocol."""

    num_keypoints = 21

    def __init__(self, n, size, seed):
        rng = np.random.default_rng(seed)
        self.size = size
        self.images = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
        # some keypoints fall off the image: their targets get weight 0
        self.kps = rng.uniform(-0.1 * size, 1.1 * size, size=(n, 21, 2)).astype(np.float32)
        self.vis = (rng.uniform(size=(n, 21)) > 0.15).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def fetch_raw(self, i, rng, raw_size):
        assert raw_size == self.size
        return {
            "image_u8": self.images[i],
            "keypoint2d": self.kps[i],
            "visible": self.vis[i],
            "intrinsic_matrix": np.eye(3, dtype=np.float32),
        }


def test_predict_uint8_matches_jax(pair):
    jmodel, variables, model = pair
    frames = np.random.default_rng(0).integers(0, 256, size=(4, IMAGE, IMAGE, 3),
                                               dtype=np.uint8)
    predict = evaluate.make_predict_fn(
        model, image_size=IMAGE, heatmap_size=HEATMAP, uint8_input=True, device="cpu"
    )
    jpredict = jevaluate.make_predict_fn(
        jmodel, image_size=IMAGE, heatmap_size=HEATMAP, uint8_input=True
    )
    coords, maxvals = predict(frames)
    jcoords, jmaxvals = jpredict(variables, jnp.asarray(frames))
    assert tuple(coords.shape) == (4, 21, 2) and tuple(maxvals.shape) == (4, 21, 1)
    assert not model.training
    # heatmaps of the same normalized frames, to find the prominent peaks
    from dahpe_tpu.data.device_aug import IMAGENET_MEAN, IMAGENET_STD

    x = (frames.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    y = jmodel.apply(variables, jnp.asarray(x), train=False, gl_coeff=0.0)["y"]
    prominent = _prominent(y)
    assert prominent.mean() > 0.8
    np.testing.assert_array_equal(coords.numpy()[prominent], np.asarray(jcoords)[prominent])
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(jmaxvals), rtol=2e-3, atol=2e-4)
    # float input path (pre-normalized frames) decodes the same
    fcoords, _ = evaluate.make_predict_fn(
        model, image_size=IMAGE, heatmap_size=HEATMAP, device="cpu"
    )(torch.from_numpy(x))
    np.testing.assert_array_equal(fcoords.numpy()[prominent], coords.numpy()[prominent])


def test_eval_step_matches_jax(pair):
    jmodel, variables, model = pair
    rng = np.random.default_rng(1)
    image = rng.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    kp = rng.uniform(0, IMAGE, size=(4, 21, 2)).astype(np.float32)
    target, weight = j_generate_target(
        jnp.asarray(kp), jnp.ones((4, 21)), (HEATMAP, HEATMAP), (IMAGE, IMAGE)
    )
    jbatch = {"image": jnp.asarray(image), "target": target, "weight": weight}
    ref = jevaluate.make_eval_step(jmodel)(variables, jbatch)
    out = evaluate.make_eval_step(model, device="cpu")(
        {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    )
    y = jmodel.apply(variables, jnp.asarray(image), train=False, gl_coeff=0.0)["y"]
    assert _prominent(y).all()
    np.testing.assert_array_equal(out["acc_per_joint"].numpy(), np.asarray(ref["acc_per_joint"]))
    np.testing.assert_array_equal(out["pred"].numpy(), np.asarray(ref["pred"]))
    assert int(out["cnt"]) == int(ref["cnt"])
    np.testing.assert_allclose(float(out["avg_acc"]), float(ref["avg_acc"]), rtol=1e-6)
    np.testing.assert_allclose(
        out["loss_per_sample"].numpy(), np.asarray(ref["loss_per_sample"]), rtol=2e-3
    )


def test_eval_loader_batches_match_jax():
    source = ArraySource(5, IMAGE, seed=2)
    loader = DeviceDataStore(source, device="cpu", raw_size=IMAGE, verbose=False).eval_loader(
        2, heatmap_size=HEATMAP
    )
    jloader = JDeviceDataStore(source, raw_size=IMAGE, verbose=False).eval_loader(
        2, heatmap_size=HEATMAP
    )
    assert loader.device_finalized and len(loader) == len(jloader) == 3
    items, jitems = list(loader), list(jloader)
    assert [i["n_real"] for i in items] == [j["n_real"] for j in jitems] == [2, 2, 1]
    for item, jitem in zip(items, jitems):
        got, ref = item["batch"], {k: np.asarray(v) for k, v in jitem["batch"].items()}
        np.testing.assert_allclose(got["image"].numpy(), ref["image"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["weight"].numpy(), ref["weight"])
        np.testing.assert_array_equal(got["target"].numpy() == 0, ref["target"] == 0)
        np.testing.assert_allclose(got["target"].numpy(), ref["target"], rtol=1e-6, atol=0)
    # the padding row of the last batch is zero-masked
    assert not items[-1]["batch"]["target"][1].any()
    assert not items[-1]["batch"]["weight"][1].any()


def test_validate_matches_jax(pair, capsys):
    jmodel, variables, model = pair
    source = ArraySource(5, IMAGE, seed=3)
    store = DeviceDataStore(source, device="cpu", raw_size=IMAGE, verbose=False)
    jstore = JDeviceDataStore(source, raw_size=IMAGE, verbose=False)
    dataset = Hand21KeypointDataset()
    jdataset = JHand21("unused", [])
    assert dataset.keypoints_group == jdataset.keypoints_group

    got = evaluate.validate(store.eval_loader(2, heatmap_size=HEATMAP), model, dataset,
                            print_freq=1, device="cpu")
    ref = jevaluate.validate(
        jstore.eval_loader(2, heatmap_size=HEATMAP), jmodel, variables, jdataset,
        image_size=IMAGE, heatmap_size=HEATMAP, print_freq=1000,
    )
    assert got == ref
    assert "Test: [2/3]" in capsys.readouterr().out
    assert store.nbytes() >= 5 * IMAGE * IMAGE * 3


class HostSource(ArraySource):
    """The split as a host dataset: ``fetch`` returns the normalized frame."""

    def fetch(self, i, rng):
        image = (self.images[i].astype(np.float32) / 255.0 - [0.485, 0.456, 0.406]) \
            / [0.229, 0.224, 0.225]
        return {"image": image.astype(np.float32), "keypoint2d": self.kps[i],
                "visible": self.vis[i]}


def test_validate_refuses_host_loaders(pair):
    """Host loaders, refused until the host data path was ported, are now
    finalized on the device: PCK over a ``BatchLoader`` (trailing partial
    batch padded) equals the JAX package's over its own loader."""
    from dahpe_tpu.data import BatchLoader as JBatchLoader

    from dahpe_tpu_torch.data import BatchLoader

    jmodel, variables, model = pair
    source = HostSource(5, IMAGE, seed=4)
    kw = dict(shuffle=False, drop_last=False, num_workers=1)
    got = evaluate.validate(BatchLoader(source, 2, **kw), model, Hand21KeypointDataset(),
                            image_size=IMAGE, heatmap_size=HEATMAP, print_freq=1000,
                            device="cpu")
    ref = jevaluate.validate(JBatchLoader(source, 2, **kw), jmodel, variables,
                             JHand21("unused", []), image_size=IMAGE, heatmap_size=HEATMAP,
                             print_freq=1000)
    assert got == ref


@pytest.mark.parametrize("factory", ["make_predict_fn", "make_eval_step"])
def test_entry_points_default_to_cuda(factory):
    """Without ``device`` the entry points put the model on the card: on a
    machine without one they raise rather than serve on the CPU."""
    model = torch.nn.Conv2d(3, 21, 1)
    make = getattr(evaluate, factory)
    if torch.cuda.is_available():
        make(model)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make(model)
    make(model, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
