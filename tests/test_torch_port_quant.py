"""PyTorch port, post-training int8 quantization: ``dahpe_tpu_torch.quant``
against ``dahpe_tpu/quant.py`` on the same weights and inputs (counterpart of
``tests/test_quant.py``).

- Folded and quantized weights are bit-equal to the JAX package's after the
  layout transpose (HWIO → ``(O, I, kh, kw)``): both fold and quantize in
  numpy with the same float32 operations.
- One int8 convolution of each kind (stem, stride 2, 1×1, grouped, deconv,
  ``head_out``) is ``torch.equal`` to JAX's int32 convolution
  (``preferred_element_type=int32``) on the same int8 input: both are exact.
- The whole int8 forward, on trees carried across by ``quantized_from_jax``
  and fed the same activation scales, tracks JAX's heatmaps: mean absolute
  error below 1e-2·std with float32 glue and 0.1·std with bfloat16 glue
  (``tests/test_quant.py:106``'s bound against the float forward). Float
  noise in one package's glue can move an activation across a rounding
  boundary of the next quantizer, so the two are not bit-equal.
- The sort-based percentile matches ``jnp.percentile`` within rtol 1e-5 on
  more than 2²⁴ elements, where ``torch.quantile`` refuses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu import quant as jquant
from dahpe_tpu.models import resnet as jresnet
from tests.test_torch_port_models import model_pair, randomize_variables

from dahpe_tpu_torch import models, quant
from dahpe_tpu_torch.utils.torch_import import quantized_from_jax, state_dict_from_jax

IMAGE = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes, and torch's default of one thread per core oversubscribes
    the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def grouped_pair(seed=5):
    """A mini ResNeXt-style model (grouped 3×3 convs, 4 groups) in both
    packages with the same random weights."""
    jmodel = jmodels.MultiHeadPoseResNet(
        backbone=jmodels.ResNet(block=jresnet.Bottleneck, layers=[1, 1, 1, 1], groups=4,
                                base_width=16), num_keypoints=21)
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, jnp.zeros((1, IMAGE, IMAGE, 3)), train=False,
                                gl_coeff=0.0), jax.random.key(0))
    variables = randomize_variables(shapes, seed)
    model = models.MultiHeadPoseResNet(
        models.ResNet(models.Bottleneck, [1, 1, 1, 1], groups=4, base_width=16),
        num_keypoints=21)
    model.load_state_dict(state_dict_from_jax(variables))
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module", params=["basic", "bottleneck", "grouped"])
def pair(request):
    if request.param == "grouped":
        return grouped_pair()
    return model_pair(request.param, image_size=IMAGE, seed=4)


def _entries(jtree, ptree, path=""):
    """``(path, jax entry, port entry)`` for every conv of two trees."""
    if isinstance(jtree, dict) and ("w" in jtree or "wq" in jtree):
        yield path, jtree, ptree
    elif isinstance(jtree, dict):
        assert set(jtree) == set(ptree), path
        for k in jtree:
            yield from _entries(jtree[k], ptree[k], f"{path}/{k}")
    else:
        assert len(jtree) == len(ptree), path
        for i, (j, p) in enumerate(zip(jtree, ptree)):
            yield from _entries(j, p, f"{path}/{i}")


def _hwio(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def test_folded_weights_equal_jax(pair):
    _, variables, model = pair
    jf = jquant.fold_serving_params(variables)
    pf = quant.fold_serving_params(model.state_dict())
    entries = list(_entries(jf, pf))
    assert len(entries) >= 8
    for path, j, p in entries:
        assert p["w"].dtype == np.float32, path
        np.testing.assert_array_equal(p["w"], _hwio(j["w"]), err_msg=path)
        np.testing.assert_array_equal(p["b"], np.asarray(j["b"]), err_msg=path)


def test_quantized_weights_equal_jax(pair):
    _, variables, model = pair
    jf = jquant.fold_serving_params(variables)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, IMAGE, IMAGE, 3)), jnp.float32)
    scales = jquant.calibrate_act_scales(jf, x)
    jq = jquant.quantize_serving(jf, scales)
    pq = quant.quantize_serving(quant.fold_serving_params(model.state_dict()), scales)
    carried = quantized_from_jax(jq)
    for path, j, p in _entries(jq, pq):
        assert p["wq"].dtype == np.int8, path
        np.testing.assert_array_equal(p["wq"], _hwio(j["wq"]), err_msg=path)
        np.testing.assert_array_equal(p["sw"], np.asarray(j["sw"]), err_msg=path)
        assert p["sx"] == j["sx"], path
    for path, c, p in _entries(carried, pq):
        for leaf in ("wq", "sw", "b", "sx"):
            np.testing.assert_array_equal(c[leaf], p[leaf], err_msg=f"{path}/{leaf}")


# (C, O, k, stride, padding, lhs_dilation, groups, spatial): one conv of each
# kind the serving forward runs; the 4x4 ones have at most 16 rows a frame,
# the case where the product is padded to cuBLASLt's row minimum
CONV_CASES = {
    "stem": (3, 64, 7, 2, 3, None, 1, 32),
    "stride2": (16, 24, 3, 2, 1, None, 1, 16),
    "1x1": (32, 16, 1, 1, 0, None, 1, 4),
    "downsample": (32, 40, 1, 2, 0, None, 1, 8),
    "grouped": (32, 32, 3, 1, 1, None, 4, 8),
    "deconv": (16, 8, 4, 1, (2, 2), (2, 2), 1, 4),
    "head_out": (32, 21, 1, 1, 0, None, 1, 16),
}


@pytest.mark.parametrize("kind", list(CONV_CASES))
def test_int8_conv_equals_jax_int32_conv(kind):
    c, o, k, stride, padding, lhs, groups, size = CONV_CASES[kind]
    rng = np.random.default_rng(len(kind))
    x = rng.integers(-127, 128, (2, size, size, c), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, c // groups, o), dtype=np.int8)  # HWIO
    ref = np.asarray(jquant._conv_base(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                       padding=padding, lhs_dilation=lhs,
                                       preferred=jnp.int32))
    xq, wq = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(_hwio(w)))
    kw = dict(stride=stride, padding=padding, lhs_dilation=lhs)
    got = quant.int8_conv(xq, wq, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert torch.equal(got, torch.from_numpy(np.array(ref))), kind
    assert torch.equal(quant.int8_conv_plain(xq, wq, **kw), got), kind
    assert np.abs(ref).max() > 2**15  # sums far beyond int16: the int32 path is exercised


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
@pytest.mark.parametrize("glue,bound", [("float32", 1e-2), ("bfloat16", 0.1)],
                         ids=["f32glue", "bf16glue"])
def test_apply_int8_tracks_jax(kind, glue, bound):
    _, variables, _ = model_pair(kind, image_size=IMAGE, seed=4)
    rng = np.random.default_rng(6)
    calib = rng.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    x = rng.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    jf = jquant.fold_serving_params(variables)
    jq = jquant.quantize_serving(jf, jquant.calibrate_act_scales(jf, jnp.asarray(calib)))
    y_j = np.asarray(jquant.apply_int8(jq, jnp.asarray(x), glue=jnp.dtype(glue)))
    pq = quant.to_torch(quantized_from_jax(jq))
    y_p = quant.apply_int8(pq, torch.from_numpy(x), glue=getattr(torch, glue)).numpy()
    assert y_p.dtype == np.float32 and y_p.shape == y_j.shape == (4, 16, 16, 21)
    err = np.abs(y_p - y_j)
    print(f"{kind} {glue}: mean abs {err.mean():.3e}, worst {err.max():.3e}, "
          f"std {y_j.std():.3e}")
    assert err.mean() < bound * y_j.std(), (err.mean(), y_j.std())


@pytest.mark.parametrize("q", [99.0, 99.9])
def test_sorted_percentile_matches_jnp_beyond_quantile_limit(q):
    n = 2**24 + 4099  # torch.quantile refuses more than 2**24 elements
    a = np.abs(np.random.default_rng(int(q)).standard_normal(n).astype(np.float32))
    ref = float(jnp.percentile(jnp.asarray(a), q))
    got = float(quant.sorted_percentile(torch.from_numpy(a), q))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("percentile", [None, 99.9], ids=["absmax", "p99.9"])
def test_calibration_matches_jax(percentile):
    """Activation ranges of the same float pass: within the forward's rtol
    2e-3 (convs accumulate in another order in torch and XLA)."""
    _, variables, model = model_pair("bottleneck", image_size=IMAGE, seed=4)
    x = np.random.default_rng(7).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = jquant.calibrate_act_scales(jquant.fold_serving_params(variables), jnp.asarray(x),
                                      percentile=percentile)
    got = quant.calibrate_act_scales(quant.fold_serving_params(model), torch.from_numpy(x),
                                     percentile=percentile)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-3, err_msg=name)


def test_percentile_calibration_robust_to_outlier():
    """The port of ``tests/test_quant.py:109``: percentile calibration is the
    absmax path at 100, shrugs off one poisoned sample in 128, where absmax
    inflates ~50x."""
    _, _, model = model_pair("basic", image_size=32, seed=6)
    folded = quant.fold_serving_params(model)
    calib = torch.from_numpy(
        np.random.default_rng(8).standard_normal((128, 32, 32, 3)).astype(np.float32))
    poisoned = calib.clone()
    poisoned[0] *= 50.0
    s_abs = quant.calibrate_act_scales(folded, calib)
    s_100 = quant.calibrate_act_scales(folded, calib, percentile=100.0)
    for k in s_abs:
        np.testing.assert_allclose(s_100[k], s_abs[k], rtol=1e-3)
    s_abs_bad = quant.calibrate_act_scales(folded, poisoned)
    s_pct_bad = quant.calibrate_act_scales(folded, poisoned, percentile=99.0)
    assert s_abs_bad["stem"] > 10 * s_abs["stem"]
    assert s_pct_bad["stem"] <= 1.5 * s_abs["stem"]


@pytest.mark.parametrize("multi_head", [True, False], ids=["multi_head", "pose_resnet"])
def test_folded_forward_matches_model(multi_head):
    """Gate 1 of ``tests/test_quant.py``: the folded functional forward is
    the model's eval forward (BN folding and the deconv as an lhs-dilated
    conv are exact transforms), up to float rounding."""
    _, _, model = model_pair("bottleneck", image_size=IMAGE, seed=9)
    if not multi_head:
        pose = models.PoseResNet(models.ResNet(models.Bottleneck, [1, 1, 1, 1]), num_keypoints=21)
        sd = pose.state_dict()
        sd.update({k: v for k, v in model.state_dict().items() if k in sd})
        sd["head.weight"] = model.state_dict()["head.3.weight"]
        sd["head.bias"] = model.state_dict()["head.3.bias"]
        pose.load_state_dict(sd)
        model = pose.eval()
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32))
    with torch.no_grad():
        y_ref = model(x)["y"] if multi_head else model(x)
    y_fold = quant.apply_folded(quant.fold_serving_params(model), x)
    np.testing.assert_allclose(y_fold.numpy(), y_ref.numpy(), rtol=2e-4, atol=2e-5)


def test_int8_predict_fn_contract():
    """The ``(quantized, images) -> (coords, maxvals)`` contract of
    ``evaluate.make_predict_fn``, uint8 ingest included."""
    _, _, model = model_pair("basic", image_size=IMAGE, seed=4)
    calib = torch.from_numpy(
        np.random.default_rng(5).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32))
    qtree = quant.to_torch(quant.quantize_model(model, calib))
    predict = quant.make_int8_predict_fn(image_size=IMAGE, heatmap_size=16, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(6).standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32))
    coords, maxvals = predict(qtree, x)
    assert tuple(coords.shape) == (3, 21, 2) and tuple(maxvals.shape) == (3, 21, 1)
    assert float(coords.max()) <= IMAGE  # image-pixel scale
    frames = np.random.default_rng(0).integers(0, 255, (3, IMAGE, IMAGE, 3), dtype=np.uint8)
    pred8 = quant.make_int8_predict_fn(image_size=IMAGE, heatmap_size=16, uint8_input=True,
                                       device="cpu")
    coords8, _ = pred8(qtree, torch.from_numpy(frames))
    assert tuple(coords8.shape) == (3, 21, 2)
