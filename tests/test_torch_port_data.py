"""PyTorch port, host data: the dataset readers, transforms, synthetic
domains, decoded cache and input pipeline of ``dahpe_tpu_torch.data``
against the JAX package's on the same fixtures (``tests/fixtures.py``) and
seeds.

Everything on the host is numpy and PIL in both packages, so sample lists,
crops, transforms, manifests and batch orders are compared exactly; the
Gaussian targets of ``finalize_batch`` are held to atol 1e-6 (``expf``
against XLA's ``exp``).
"""

import json
import os

import numpy as np
import pytest
import torch

from dahpe_tpu import data as jdata
from dahpe_tpu.core import geometry as jgeometry
from dahpe_tpu.data import transforms as JT
from dahpe_tpu.data.cache import DecodedCache as JDecodedCache
from dahpe_tpu.data.pipeline import finalize_batch as jfinalize_batch
from tests.fixtures import make_h3d_fixture, make_rhd_fixture, make_stb_fixture

from dahpe_tpu_torch import data
from dahpe_tpu_torch.core import geometry
from dahpe_tpu_torch.data import pipeline
from dahpe_tpu_torch.data import transforms as T

NAMES = ("RenderedHandPose", "Hand3DStudio", "STB")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    return {
        "RenderedHandPose": make_rhd_fixture(str(base / "rhd"), n=6,
                                             sets=("training", "evaluation")),
        "Hand3DStudio": make_h3d_fixture(str(base / "h3d"), n=20),
        "STB": make_stb_fixture(str(base / "stb"), n=4),
    }


def _pair(name, root, split="train", image_size=64, transforms=True):
    """The same split from both packages (val transform at ``image_size``);
    STB's fixture holds only its test sequences."""
    split = "test" if name == "STB" else split
    kw = dict(root=root, split=split, image_size=(image_size,) * 2, heatmap_size=(16, 16))
    jt = JT.val_transform(image_size) if transforms else None
    pt = T.val_transform(image_size) if transforms else None
    return jdata.get_dataset(name, transforms=jt, **kw), data.get_dataset(name, transforms=pt, **kw)


def _assert_items_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("name", NAMES)
def test_sample_lists_match_jax(roots, name):
    ref, got = _pair(name, roots[name])
    assert len(got) == len(ref) > 0
    for a, b in zip(ref.samples, got.samples):
        _assert_items_equal({k: np.asarray(v) for k, v in a.items()},
                            {k: np.asarray(v) for k, v in b.items()})


@pytest.mark.parametrize("name", NAMES)
def test_fetch_raw_is_byte_equal(roots, name):
    ref, got = _pair(name, roots[name], transforms=False)
    rng = np.random.default_rng(0)
    for i in range(len(ref)):
        _assert_items_equal(ref.fetch_raw(i, rng, 96), got.fetch_raw(i, rng, 96))
        assert got.fetch_raw(i, rng, 96)["image_u8"].dtype == np.uint8


@pytest.mark.parametrize("name", NAMES)
def test_val_transform_fetch_matches_jax(roots, name):
    ref, got = _pair(name, roots[name], split="test")
    for i in range(len(ref)):
        a, b = ref.fetch(i, np.random.default_rng(i)), got.fetch(i, np.random.default_rng(i))
        assert a["image"].shape == (64, 64, 3)
        _assert_items_equal(a, b)


def test_train_transform_matches_jax_on_the_same_rng(roots):
    """The reference-parity PIL train pipeline (rotation, random resized
    crop, jitter, blur, normalize) draws from the same numpy generator."""
    kw = dict(root=roots["Hand3DStudio"], image_size=(64, 64), heatmap_size=(16, 16))
    ref = jdata.get_dataset("Hand3DStudio", transforms=JT.train_transform(64, 180), **kw)
    got = data.get_dataset("Hand3DStudio", transforms=T.train_transform(64, 180), **kw)
    for i in range(3):
        _assert_items_equal(ref.fetch(i, np.random.default_rng(10 + i)),
                            got.fetch(i, np.random.default_rng(10 + i)))


@pytest.mark.parametrize("domain", ["SyntheticHandsSource", "SyntheticHandsTarget"])
def test_synthetic_domains_render_the_same_frames(domain):
    kw = dict(root="", split="test", n=3, image_size=(64, 64), heatmap_size=(16, 16))
    ref, got = jdata.get_dataset(domain, **kw), data.get_dataset(domain, **kw)
    assert got.cache_identity == ref.cache_identity
    for i in range(3):
        _assert_items_equal(ref.fetch_raw(i, None, 64), got.fetch_raw(i, None, 64))


def test_scale_box_banker_rounding_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        left, upper = rng.uniform(-20, 300, 2).round(1)
        box = (left, upper, left + rng.integers(1, 120) + 0.5, upper + rng.integers(1, 120) + 0.5)
        scale = float(rng.choice([1.5, 1.6, 1.25]))
        assert geometry.scale_box(box, 320, 240, scale) == jgeometry.scale_box(box, 320, 240, scale)


def test_registry_and_root_check(tmp_path):
    assert set(data.DATASETS) == set(jdata.DATASETS)
    with pytest.raises(ValueError, match="unknown dataset"):
        data.get_dataset("NoSuchDataset")
    with pytest.raises(FileNotFoundError):
        data.get_dataset("RenderedHandPose", root=str(tmp_path / "missing"))
    # procedural domains need no root
    assert len(data.get_dataset("SyntheticHandsSource", root=None, n=4)) == 4


@pytest.mark.parametrize("shuffle,hosts", [(True, 1), (False, 1), (True, 2)])
def test_batch_loader_index_order_matches_jax(roots, shuffle, hosts):
    """The seeded epoch permutation and the host strides, epoch after epoch."""
    ref, got = _pair("RenderedHandPose", roots["RenderedHandPose"])
    for host in range(hosts):
        kw = dict(shuffle=shuffle, drop_last=hosts == 1, num_workers=1, seed=5,
                  host_index=host, host_count=hosts)
        jl, pl = jdata.BatchLoader(ref, 3, **kw), pipeline.BatchLoader(got, 3, **kw)
        assert len(jl) == len(pl)
        for _ in range(3):
            jl._epoch += 1
            pl._epoch += 1
            assert ([list(b) for b in jl._index_batches()]
                    == [list(b) for b in pl._index_batches()])


def test_batch_loader_batches_match_jax(roots):
    ref, got = _pair("Hand3DStudio", roots["Hand3DStudio"])
    kw = dict(shuffle=True, drop_last=False, num_workers=2, seed=2)
    jbatches = list(jdata.BatchLoader(ref, 4, **kw))
    pbatches = list(pipeline.BatchLoader(got, 4, **kw))
    assert len(jbatches) == len(pbatches) > 1
    for a, b in zip(jbatches, pbatches):
        _assert_items_equal(a, b)


def test_forever_iterator_crosses_epochs(roots):
    _, got = _pair("Hand3DStudio", roots["Hand3DStudio"])
    loader = pipeline.BatchLoader(got, 4, num_workers=1, seed=0)
    it = pipeline.ForeverIterator(lambda: iter(loader))
    for _ in range(2 * len(loader) + 1):
        assert next(it)["image"].shape == (4, 64, 64, 3)


def test_finalize_batch_targets_match_jax(roots):
    ref, got = _pair("RenderedHandPose", roots["RenderedHandPose"])
    batch = next(iter(pipeline.BatchLoader(got, 4, num_workers=1, seed=0)))
    out = pipeline.finalize_batch(batch, heatmap_size=(16, 16), image_size=(64, 64),
                                  device="cpu")
    jout = jfinalize_batch(batch, heatmap_size=(16, 16), image_size=(64, 64))
    np.testing.assert_array_equal(out["image"].numpy(), np.asarray(jout["image"]))
    np.testing.assert_array_equal(out["weight"].numpy(), np.asarray(jout["weight"]))
    np.testing.assert_allclose(out["target"].numpy(), np.asarray(jout["target"]), atol=1e-6)
    assert float(out["weight"].sum()) > 0


def test_decoded_cache_manifest_and_crops_match_jax(roots, tmp_path):
    """Same manifest, crops, metadata and warped samples: one cache
    directory serves both."""
    ref, got = _pair("RenderedHandPose", roots["RenderedHandPose"], transforms=False)
    jc = JDecodedCache(ref, str(tmp_path / "jax"), raw_size=96, num_workers=2)
    pc = data.DecodedCache(got, str(tmp_path / "port"), raw_size=96, num_workers=2)
    manifests = [json.load(open(os.path.join(d, "manifest.json")))
                 for d in (jc.cache_dir, pc.cache_dir)]
    assert manifests[0] == manifests[1]
    for i in range(len(ref)):
        _assert_items_equal(jc.fetch_raw(i, None), pc.fetch_raw(i, None))
    # the JAX package's cache directory is valid for the port as it is
    reused = data.DecodedCache(got, str(tmp_path / "jax"), raw_size=96, build=False)
    _assert_items_equal(reused.fetch_raw(0, None), got.fetch_raw(0, None, 96))
    # --host-warp through the cache: the native warp of the cached crop
    for seed in range(2):
        _assert_items_equal(jc.fetch_warped(seed, np.random.default_rng(seed), image_size=64),
                            pc.fetch_warped(seed, np.random.default_rng(seed), image_size=64))


def test_device_train_batch_is_the_augmentation_of_the_loader_batch(roots):
    """``--device-aug``: the raw uint8 batch, augmented on the generator's
    device from its draws, then Gaussian targets."""
    from dahpe_tpu_torch.core.heatmap import generate_target
    from dahpe_tpu_torch.data.device_aug import augment_batch, draw_augment_params

    _, got = _pair("RenderedHandPose", roots["RenderedHandPose"], transforms=False)
    batch = next(iter(pipeline.BatchLoader(got, 3, num_workers=1, seed=0, raw=True,
                                           raw_size=80)))
    assert batch["image_u8"].dtype == np.uint8
    out = pipeline.device_train_batch(batch, torch.Generator().manual_seed(4), image_size=64,
                                      heatmap_size=16)
    params = draw_augment_params(torch.Generator().manual_seed(4), 3, size=80)
    img, kp, _ = augment_batch(torch.from_numpy(batch["image_u8"]),
                               torch.from_numpy(batch["keypoint2d"]),
                               torch.from_numpy(batch["intrinsic_matrix"]), params,
                               out_size=64)
    target, weight = generate_target(kp, torch.from_numpy(batch["visible"]), (16, 16), (64, 64))
    assert torch.equal(out["image"], img)
    assert torch.equal(out["target"], target) and torch.equal(out["weight"], weight)


def test_device_prefetch_on_the_cpu_finalizes_in_order():
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    out = list(pipeline.device_prefetch(iter(batches), lambda b: float(b["x"][0]), size=2,
                                        device="cpu"))
    assert out == [0.0, 1.0, 2.0, 3.0, 4.0]


class _Countdown:
    """97 items, each carrying its own index."""

    def __len__(self):
        return 97

    def fetch(self, index, rng):
        rng.random()  # each worker's own generator
        return {"image": np.full((1,), index, np.int64)}


def test_batch_loader_hands_off_every_batch_once_in_order_under_thread_churn():
    """More workers than cores and a tiny switch interval: the condition
    variable hand-off still yields each batch once, in the epoch order."""
    import sys

    loader = pipeline.BatchLoader(_Countdown(), 4, shuffle=True, drop_last=False,
                                  num_workers=32, seed=9, prefetch=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            loader._epoch += 1  # the order the next epoch will take
            want = [list(b) for b in loader._index_batches()]
            loader._epoch -= 1
            got = [list(b["image"][:, 0]) for b in loader]
            assert got == want
            assert sorted(x for b in got for x in b) == list(range(97))
    finally:
        sys.setswitchinterval(interval)
