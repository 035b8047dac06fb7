"""PyTorch port, training input and labels: the rotation and pseudo-label
plain versions against the JAX package's Pallas kernels (interpret mode) and
jnp paths, the augmentation and the store's training producer on draws the
JAX package made, and the kernel wrappers' refusal to fall back.

Tolerances: the rotation is integer arithmetic on 8.8 fixed point and must
be bit-exact; labels use ``tests/test_pallas_pseudo_label.py``'s atol (1e-6,
1e-5 with a fused target); augmented images atol 1e-3 after normalize (the
crop-resize and blur are float32 products summed in another order),
keypoints atol 1e-4 px, weights equal and targets equal up to ``expf``'s
1 ulp against XLA's ``exp`` (the same zeros, rtol 1e-6, as
``tests/test_torch_port_core.py`` holds every Gaussian).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu.core import heatmap as jhm
from dahpe_tpu.data import device_aug as jaug
from dahpe_tpu.data.device_store import DeviceDataStore as JDeviceDataStore
from dahpe_tpu.ops.pallas.pseudo_label import pseudo_labels_pallas
from dahpe_tpu.ops.pallas.shear import rotate3_fused_pallas
from tests.test_torch_port_core import _assert_gaussian_close
from tests.test_torch_port_eval import ArraySource

from dahpe_tpu_torch.core import heatmap
from dahpe_tpu_torch.data import DeviceDataStore
from dahpe_tpu_torch.data import device_aug
from dahpe_tpu_torch.ops import pseudo_label, shear

SLOPES = [(0.0, 0.0), (-0.2, 0.38), (0.41421, -0.70710)]  # tests/test_pallas_shear.py:75
K = 21


def _jax_rotate(img_hwc, a, b, q, size):
    pad, ka, kb = shear.rotation_geometry(size)
    x = jnp.rot90(jnp.asarray(img_hwc).transpose(2, 0, 1), k=q, axes=(1, 2))
    return np.asarray(rotate3_fused_pallas(x, jnp.float32(a), jnp.float32(b), pad=pad,
                                           kmax_a=ka, kmax_b=kb, interpret=True))


def test_rotation_geometry_matches_the_path():
    assert shear.rotation_geometry(288) == (62, 87, 147)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_rotate3_plain_matches_pallas_kernel(q, dtype):
    """Bit-exact against ``rotate3_fused_pallas`` (interpret mode) for every
    quarter-turn, from uint8 or float canvases (the float ones not integral,
    so the fixed-point rounding is exercised)."""
    size = 48
    rng = np.random.default_rng(q)
    if dtype == "uint8":
        img = rng.integers(0, 256, (len(SLOPES), size, size, 3), dtype=np.uint8)
    else:
        img = rng.uniform(0.0, 255.0, (len(SLOPES), size, size, 3)).astype(np.float32)
    a, b = (np.asarray(v, np.float32) for v in zip(*SLOPES))
    pad, ka, kb = shear.rotation_geometry(size)
    got = shear.rotate3_fused(torch.from_numpy(img), torch.from_numpy(a), torch.from_numpy(b),
                              torch.full((len(SLOPES),), q, dtype=torch.int32),
                              pad=pad, kmax_a=ka, kmax_b=kb).numpy()
    for i in range(len(SLOPES)):
        np.testing.assert_array_equal(got[i], _jax_rotate(img[i], a[i], b[i], q, size))


def test_rotate_shears_matches_jnp_path():
    """The port's ``_rotate_shears`` (quarter-turn folded into the rotation)
    equals the JAX package's jnp ``_rotate_shears(use_pallas=False)`` bit for
    bit on the slopes XLA computes, at 64² and angles over all quarters."""
    rng = np.random.default_rng(3)
    angles = np.asarray([0.0, 33.0, -117.5, 180.0, 91.0, -44.9, 135.0, -180.0], np.float32)
    img = rng.integers(0, 256, (len(angles), 64, 64, 3), dtype=np.uint8)
    ref = np.stack([np.asarray(jaug._rotate_shears(jnp.asarray(img[i], jnp.float32),
                                                   jnp.float32(angles[i]), use_pallas=False))
                    for i in range(len(angles))])
    r = jnp.deg2rad(angles - 90.0 * jnp.round(angles / 90.0))
    slopes = (torch.tensor(np.asarray(-jnp.tan(r / 2.0))), torch.tensor(np.asarray(jnp.sin(r))))
    got = device_aug._rotate_shears(torch.from_numpy(img), torch.from_numpy(angles), slopes)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the port's own slopes (torch's tan/sin) decide the same quarter-turns
    q, _, _ = device_aug.rotation_slopes(torch.from_numpy(angles))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jnp.round(angles / 90.0), np.int32) % 4)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("gf_kind", ["union_minus", "inverse", "union_others"])
def test_pseudo_labels_plain_matches_pallas_kernel(gf_kind, fused):
    rng = np.random.default_rng(len(gf_kind) + fused)
    size, reach = (32, 4) if fused else (64, 6)
    peaks = rng.integers(0, size, size=(3, K, 2)).astype(np.int32)
    target = rng.uniform(0, 1, (3, size, size, K)).astype(np.float32) if fused else None
    for normalize in (True, False):
        kw = dict(out_size=size, reach=reach, gf_kind=gf_kind, normalize=normalize)
        gt, gf = pseudo_label.pseudo_labels(
            torch.from_numpy(peaks), None if target is None else torch.from_numpy(target), **kw)
        gt_ref, gf_ref = pseudo_labels_pallas(
            jnp.asarray(peaks), None if target is None else jnp.asarray(target),
            interpret=True, **kw)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gt_ref), atol=1e-6)
        np.testing.assert_allclose(gf.numpy(), np.asarray(gf_ref), atol=1e-5 if fused else 1e-6)


def test_heatmap_label_functions_match_jax():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((2, 64, 64, K)).astype(np.float32)
    fused = rng.uniform(0, 1, (2, 32, 32, K)).astype(np.float32)
    for scale, factor in ((1, 3.0), (2, 2.0), (4, 1.5)):
        gt = heatmap.pseudo_label_gt(torch.from_numpy(y), scale=scale, window_factor=factor)
        ref = jhm.pseudo_label_gt(jnp.asarray(y), scale=scale, window_factor=factor)
        _assert_gaussian_close(gt.numpy(), ref)  # expf vs XLA's exp: 1 ulp
    gt = heatmap.pseudo_label_gt(torch.from_numpy(y), scale=2, window_factor=2.0)
    jgt = jnp.asarray(gt.numpy())
    for fn, jfn in ((heatmap.gf_union_minus, jhm.gf_union_minus),
                    (heatmap.gf_inverse, jhm.gf_inverse),
                    (heatmap.gf_union_others, jhm.gf_union_others)):
        np.testing.assert_allclose(fn(gt).numpy(), np.asarray(jfn(jgt)), atol=1e-6)
    for target in (None, fused):
        got = heatmap.fuse_and_normalize_gf(heatmap.gf_inverse(gt), gt,
                                            None if target is None else torch.from_numpy(target))
        ref = jhm.fuse_and_normalize_gf(jhm.gf_inverse(jgt), jgt,
                                        None if target is None else jnp.asarray(target))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    zero = torch.zeros((1, 4, 4, 2))
    assert torch.equal(heatmap.fuse_and_normalize_gf(zero, zero, None), zero)  # 1e-12 guard


def test_render_gaussian_fractional_mask_matches_jax():
    """A float mask multiplies the maps, as the JAX function does; a bool
    mask is the kernel's own (``generate_target`` passes ``weight > 0.5``)."""
    rng = np.random.default_rng(9)
    mu = rng.integers(0, 16, size=(2, K, 2)).astype(np.int32)
    valid = rng.choice([0.0, 0.25, 0.5, 1.0, -1.0], size=(2, K)).astype(np.float32)
    got = heatmap.render_gaussian(torch.from_numpy(mu), 16, 16, reach=6,
                                  valid=torch.from_numpy(valid))
    ref = jhm.render_gaussian(jnp.asarray(mu), 16, 16, reach=6, valid=jnp.asarray(valid))
    _assert_gaussian_close(got.numpy(), ref)
    as_bool = heatmap.render_gaussian(torch.from_numpy(mu), 16, 16, reach=6,
                                      valid=torch.from_numpy(valid > 0.5))
    ref = jhm.render_gaussian(jnp.asarray(mu), 16, 16, reach=6, valid=jnp.asarray(valid > 0.5))
    _assert_gaussian_close(as_bool.numpy(), ref)


def _jax_draws(key, b, *, size, out_size, rotation=180.0, scale_range=(0.6, 1.3)):
    """``augment_batch``'s per-image draws, made from its own keys, as the
    port's parameter dict (with XLA's rotation slopes)."""
    keys = jax.random.split(key, (b, 3))
    rows = []
    for i in range(b):
        _, _, angle, side, offset, _ = jaug._affine_params(
            keys[i, 0], size, size, out_size, rotation, scale_range)
        kj = jax.random.split(keys[i, 1], 4)
        factors = jax.random.uniform(kj[0], (3,), minval=0.75, maxval=1.25)
        order = jax.random.permutation(kj[1], 3)
        radius = jax.random.uniform(keys[i, 2], (), minval=0.0, maxval=0.8)
        r = jnp.deg2rad(angle - 90.0 * jnp.round(angle / 90.0))
        rows.append((angle, side, offset, factors, order, radius, -jnp.tan(r / 2.0), jnp.sin(r)))
    t = lambda i, dtype=torch.float32: torch.from_numpy(  # noqa: E731
        np.stack([np.asarray(row[i]) for row in rows])).to(dtype)
    return {"angle": t(0), "side": t(1), "offset": t(2), "factors": t(3),
            "order": t(4, torch.int64), "radius": t(5), "slopes": (t(6), t(7))}


def test_augment_batch_matches_jax_on_its_draws():
    size, out, b = 48, 32, 4
    src = ArraySource(b, size, seed=4)
    key = jax.random.key(21)
    img, kp, intr = jaug.augment_batch(
        jnp.asarray(src.images), jnp.asarray(src.kps),
        jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))),
        key, out_size=out, warp="matmul")
    got = device_aug.augment_batch(
        torch.from_numpy(src.images), torch.from_numpy(src.kps),
        torch.from_numpy(np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))),
        _jax_draws(key, b, size=size, out_size=out), out_size=out)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(img), atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(kp), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(intr), rtol=1e-6)


def test_train_batch_producer_matches_jax_store():
    """The port's producer, given the rows and draws the JAX store's
    ``train_batch(key)`` made, gives the same batch."""
    size, out, hm, b = 48, 32, 8, 4
    src = ArraySource(12, size, seed=6)
    key = jax.random.key(5)
    ref = JDeviceDataStore(src, raw_size=size, verbose=False).train_batch(
        key, b, image_size=out, heatmap_size=hm)
    k = jax.random.fold_in(key, 0)  # the one device's position on the data axis
    idx = np.asarray(jax.random.choice(k, src.images.shape[0], shape=(b,), replace=False))
    params = _jax_draws(jax.random.fold_in(k, 1), b, size=size, out_size=out)
    store = DeviceDataStore(src, device="cpu", raw_size=size, verbose=False)
    got = store.train_batch_from(torch.tensor(idx, dtype=torch.int64), params,
                                 image_size=out, heatmap_size=hm)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]), atol=1e-3)
    _assert_gaussian_close(got["target"].numpy(), ref["target"])
    np.testing.assert_array_equal(got["weight"].numpy(), np.asarray(ref["weight"]))


def test_gather_warp_matches_jax_oracle():
    """The single-resample gather warp, the numerical oracle, equals the JAX
    package's ``warp="gather"`` on its own draws."""
    size, out, b = 48, 32, 3
    src = ArraySource(b, size, seed=8)
    key = jax.random.key(4)
    eye = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    ref, kp, _ = jaug.augment_batch(jnp.asarray(src.images), jnp.asarray(src.kps),
                                    jnp.asarray(eye), key, out_size=out, warp="gather")
    got, got_kp, _ = device_aug.augment_batch(
        torch.from_numpy(src.images), torch.from_numpy(src.kps), torch.from_numpy(eye),
        _jax_draws(key, b, size=size, out_size=out), out_size=out, warp="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(got_kp.numpy(), np.asarray(kp), atol=1e-4)


def test_draws_and_stream_are_seeded():
    size, b = 48, 16
    params = device_aug.draw_augment_params(torch.Generator().manual_seed(1), b, size=size)
    again = device_aug.draw_augment_params(torch.Generator().manual_seed(1), b, size=size)
    for name, value in params.items():
        assert torch.equal(value, again[name]), name
    assert float(params["angle"].abs().max()) <= 180.0
    side = params["side"]
    assert float(side.min()) >= 1.0 and float(side.max()) <= size
    assert bool(((params["offset"] >= 0) & (params["offset"] + side[:, None] <= size)).all())
    assert torch.equal(params["order"].sort(dim=1).values, torch.arange(3).repeat(b, 1))
    assert float(params["factors"].min()) >= 0.75 and float(params["factors"].max()) <= 1.25
    assert 0.0 <= float(params["radius"].min()) and float(params["radius"].max()) <= 0.8

    store = DeviceDataStore(ArraySource(10, size, seed=2), device="cpu", raw_size=size,
                            verbose=False)
    cfg = dict(image_size=32, heatmap_size=8)
    store.seed_stream(7)
    first = store.next_train_batch(4, **cfg)
    saved = store.stream_data()
    second = store.next_train_batch(4, **cfg)
    store.seed_stream(saved)  # resume: the same stream continues
    assert torch.equal(store.next_train_batch(4, **cfg)["image"], second["image"])
    assert not torch.equal(first["image"], second["image"])
    assert torch.equal(store.train_batch(3, 4, **cfg)["target"],
                       store.train_batch(store.generator(3), 4, **cfg)["target"])


def test_fused_da_iteration_equals_producer_then_step():
    """``make_fused_da_iteration`` is the stores' producers and the DA step
    in one call: from the same weights and generator seeds it gives the
    same state as producing the batches and stepping separately, returns
    the batches it drew, and the generators advance in place."""
    from dahpe_tpu_torch import models
    from dahpe_tpu_torch.train import create_da_state, make_da_train_step, make_fused_da_iteration

    stores = [DeviceDataStore(ArraySource(8, 48, seed=s), device="cpu", raw_size=48,
                              verbose=False) for s in (1, 2)]
    cfg = dict(image_size=64, heatmap_size=16)
    states = []
    for fused in (True, False):
        torch.manual_seed(0)
        model = models.MultiHeadPoseResNet(models.ResNet(models.Bottleneck, [1, 1, 1, 1]),
                                           num_keypoints=K)
        state = create_da_state(model, device="cpu")
        s_gen, t_gen = stores[0].generator(3), stores[1].generator(4)
        if fused:
            call = make_fused_da_iteration(model, stores[0], stores[1], 2, **cfg)
            state, metrics, b_s, b_t = call(state, s_gen, t_gen)
        else:
            step = make_da_train_step(model)
            b_s = stores[0].traced_batch_fn(2, **cfg)(s_gen)
            b_t = stores[1].traced_batch_fn(2, **cfg)(t_gen)
            state, metrics = step(state, b_s, b_t)
        states.append((state.model.state_dict(), s_gen.get_state(), t_gen.get_state(),
                       {**b_s, **{"t_" + k: v for k, v in b_t.items()}}))
    (a, sa, ta, ba), (b, sb, tb, bb) = states
    assert torch.equal(sa, sb) and torch.equal(ta, tb)
    assert ba.keys() == bb.keys() and all(torch.equal(ba[k], bb[k]) for k in ba)
    assert not torch.equal(sa, stores[0].generator(3).get_state())
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("call", [
    lambda: shear.rotate3_fused_cuda(
        torch.zeros((1, 8, 8, 3), dtype=torch.uint8), torch.zeros(1), torch.zeros(1),
        torch.zeros(1, dtype=torch.int32), pad=4, kmax_a=4, kmax_b=6),
    lambda: pseudo_label.pseudo_labels_cuda(torch.zeros((1, K, 2), dtype=torch.int32),
                                            out_size=8),
], ids=["rotate3", "pseudo_labels"])
def test_new_kernel_wrappers_never_fall_back(call):
    """The ``*_cuda`` wrappers refuse CPU tensors instead of computing the
    plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_dispatchers_refuse_other_devices():
    meta = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        shear.rotate3_fused(meta, meta[:, 0, 0, 0].float(), meta[:, 0, 0, 0].float(),
                            meta[:, 0, 0, 0].int(), pad=4, kmax_a=4, kmax_b=6)
    with pytest.raises(ValueError, match="no kernel"):
        pseudo_label.pseudo_labels(torch.zeros((1, K, 2), dtype=torch.int32, device="meta"),
                                   out_size=8)
