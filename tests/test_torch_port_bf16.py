"""PyTorch port, the bfloat16 compute dtype (``--bf16``) against the JAX
package in bfloat16, on the CPU at a small size.

The JAX package has no bfloat16 tolerance to copy, so every comparison of a
bfloat16 result states two bounds (:func:`assert_bf16`):

(a) the port's distance to the JAX package's bfloat16 result, an RMS
    relative to that result's norm, is at most a number written beside the
    case;
(b) the port's distance to the JAX package's float32 result is between 0.5
    and 1.5 times the JAX package's own bfloat16 distance to it (and zero
    where that is zero).

Bound (b) holds whatever the right absolute tolerance is: a port that
rounds more often than the JAX package lands above it, one that silently
computes in float32 below it. Peaks and the labels built from them are
exact: they are integers and float32 maps from the same peaks.

Weights: the mini ``[1, 1, 1, 1]`` backbones of
``tests/test_torch_port_models.py`` (fan-in scaled, random BN statistics);
the DA and pretrain steps use ``tests/test_da_parity.py``'s ``0.05·randn``
weights, as the float32 DA parity does. "Fresh heads" are the JAX
package's initialisation of the heads and deconvolutions, N(0, 1e-3²) with
zero biases: their bfloat16 heatmaps are small and hold tied maxima.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import evaluate as jevaluate
from dahpe_tpu import models as jmodels
from dahpe_tpu.core.heatmap import peaks_from_heatmap as j_peaks
from dahpe_tpu.data.datasets.base import Hand21KeypointDataset as JHand21
from dahpe_tpu.data.device_store import DeviceDataStore as JDeviceDataStore
from dahpe_tpu.train import DATrainState as JDATrainState
from dahpe_tpu.train import PretrainState as JPretrainState
from dahpe_tpu.train import disparity as jdisparity
from dahpe_tpu.train import make_da_train_step as j_make_da_train_step
from dahpe_tpu.train import make_pretrain_step as j_make_pretrain_step
from dahpe_tpu.train.optim import DA_PARTITIONS as J_DA_PARTITIONS
from dahpe_tpu.train.optim import init_partitioned, torch_sgd
from dahpe_tpu.train.pretrain import PRETRAIN_PARTITIONS as J_PRETRAIN_PARTITIONS
from tests.test_torch_port_eval import ArraySource
from tests.test_torch_port_models import (
    _map_tree,
    jax_backbone,
    port_backbone,
    randomize_variables,
)
from tests.test_torch_port_train import _batches, _torch_batch, da_variables

from dahpe_tpu_torch import evaluate, models, serving
from dahpe_tpu_torch.core.heatmap import peaks_from_heatmap
from dahpe_tpu_torch.data import DeviceDataStore, Hand21KeypointDataset
from dahpe_tpu_torch.train import (
    create_da_state,
    create_pretrain_state,
    disparity,
    make_da_train_step,
    make_pretrain_step,
)
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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(xs) -> np.ndarray:
    return np.concatenate([_f32(x).reshape(-1) for x in xs])


def assert_bf16(got, ref16, ref32, a: float, name: str) -> tuple[float, float]:
    """Bounds (a) and (b) of the module docstring on lists of arrays (held
    as one vector); returns (the (a) distance, the (b) ratio)."""
    got, ref16, ref32 = _flat(got), _flat(ref16), _flat(ref32)
    assert got.shape == ref16.shape == ref32.shape, name
    assert np.isfinite(got).all(), name
    dist = float(np.linalg.norm(got - ref16) / max(np.linalg.norm(ref16), 1e-30))
    assert dist <= a, f"{name}: (a) {dist:.4g} of JAX bf16's norm off it, bound {a}"
    own = float(np.linalg.norm(ref16 - ref32))
    if own == 0.0:  # bfloat16 did not move the JAX result: neither may the port
        assert np.array_equal(got, ref32), f"{name}: JAX bf16 equals float32, the port not"
        return dist, 1.0
    ratio = float(np.linalg.norm(got - ref32)) / own
    assert 0.5 <= ratio <= 1.5, (
        f"{name}: (b) {ratio:.3f}x JAX bf16's own distance to JAX float32")
    return dist, ratio


# ---------------------------------------------------------------- models

def _jax_model(arch, kind, dtype=None):
    if arch == "pose":
        return jmodels.PoseResNet(backbone=jax_backbone(kind, dtype), num_keypoints=K,
                                  dtype=dtype)
    return jmodels.MultiHeadPoseResNet(backbone=jax_backbone(kind, dtype), num_keypoints=K,
                                       dtype=dtype)


def _port_model(arch, kind, variables, dtype=None):
    cls = models.PoseResNet if arch == "pose" else models.MultiHeadPoseResNet
    model = cls(port_backbone(kind, dtype), num_keypoints=K, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


def fresh_heads(variables, seed):
    """``variables`` with every head and deconvolution at the JAX package's
    initialisation: kernels N(0, 1e-3²), biases 0 (BN untouched)."""
    rng = np.random.default_rng(seed)

    def init(path, v):
        if path[0] not in ("head", "head_adv", "head_adv2", "head_adv3", "upsampling"):
            return v
        if path[-1] == "kernel":
            return (1e-3 * rng.standard_normal(np.shape(v))).astype(np.float32)
        return np.zeros(np.shape(v), np.float32) if path[-1] == "bias" else v

    return {"params": _map_tree(init, variables["params"]),
            "batch_stats": variables["batch_stats"]}


def _variables(arch, kind, seed, heads="random"):
    jmodel = _jax_model(arch, kind)
    x0 = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, x0, train=False), jax.random.key(0))
    variables = randomize_variables(shapes, seed)
    return fresh_heads(variables, seed + 1) if heads == "fresh" else variables


def _forward_all(arch, kind, variables, x, train):
    """JAX float32, JAX bf16 and the port's bf16 forward: (outputs, BN
    stats) each, the outputs a dict of arrays."""
    out = {}
    for who, dtype in (("j32", None), ("j16", jnp.bfloat16)):
        jm = _jax_model(arch, kind, dtype)
        kw = {} if arch == "pose" else {"gl_coeff": 0.1}
        if train:
            y, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                              **kw)
        else:
            y, upd = jm.apply(variables, jnp.asarray(x), train=False, **kw), None
        out[who] = ({"y": y} if arch == "pose" else y,
                    None if upd is None else state_dict_from_jax(upd))
    model = _port_model(arch, kind, variables, torch.bfloat16).train(train)
    with torch.no_grad():
        y = model(torch.from_numpy(x), **({} if arch == "pose" else {"gl_coeff": 0.1}))
    out["port"] = ({"y": y} if arch == "pose" else y,
                   {k: v for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))} if train else None)
    return out


FORWARD_CASES = [
    # (arch, backbone, heads, train, bound (a) for the outputs)
    ("multi", "bottleneck", "random", False, 0.02),
    ("multi", "bottleneck", "random", True, 0.1),
    ("multi", "basic", "fresh", False, 0.02),
    ("multi", "basic", "fresh", True, 0.1),
    ("pose", "basic", "random", False, 0.02),
    ("pose", "basic", "random", True, 0.05),
]


@pytest.mark.parametrize("arch,kind,heads,train,a", FORWARD_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{'train' if c[3] else 'eval'}"
                              for c in FORWARD_CASES])
def test_forward_matches_jax_bf16(arch, kind, heads, train, a, capsys):
    """Every output is bfloat16 as in JAX and within (a) and (b); in train
    mode the BN running statistics are float32 and within (a) 1e-3 and
    (b)."""
    variables = _variables(arch, kind, 7, heads)
    x = np.random.default_rng(1).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    out = _forward_all(arch, kind, variables, x, train)
    (j32, s32), (j16, s16), (port, sp) = out["j32"], out["j16"], out["port"]
    report = []
    for name in port:
        assert j16[name].dtype == jnp.bfloat16 and port[name].dtype == torch.bfloat16, name
        report.append((name, *assert_bf16([port[name]], [j16[name]], [j32[name]], a, name)))
    if train:
        keys = sorted(sp)
        assert all(sp[k].dtype == torch.float32 for k in keys)
        report.append(("bn", *assert_bf16([sp[k] for k in keys], [s16[k] for k in keys],
                                          [s32[k] for k in keys], 1e-3, "bn stats")))
    with capsys.disabled():
        print("\n  " + "; ".join(f"{n} (a) {d:.4f} (b) {r:.2f}" for n, d, r in report))


# ---------------------------------------------------------------- ties, labels

@pytest.fixture(scope="module")
def fresh_bf16_heatmaps():
    """JAX bf16 heatmaps of a fresh-head model in train mode (its main head
    and all three adversarial heads), some of their maxima tied."""
    variables = _variables("multi", "bottleneck", 9, "fresh")
    x = np.random.default_rng(3).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    out, _ = _jax_model("multi", "bottleneck", jnp.bfloat16).apply(
        variables, jnp.asarray(x), train=True, gl_coeff=0.1, mutable=["batch_stats"])
    return out


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_f32(a))).to(torch.bfloat16)


def test_peaks_of_tied_bf16_maps_equal_jax(fresh_bf16_heatmaps):
    """First-occurrence argmax on bfloat16 maps, bit for bit: the fresh
    heads' heatmaps of all four heads (tied maxima among them), and small
    integers in bfloat16 (ties in every map, some maps all <= 0)."""
    rng = np.random.default_rng(4)
    maps = [fresh_bf16_heatmaps[n] for n in ("y", "y_adv", "y_adv2", "y_adv3")]
    maps.append(jnp.asarray(rng.integers(-6, 3, (4, HM, HM, K)), jnp.bfloat16))
    ties = 0
    for y in maps:
        flat = _f32(y).reshape(y.shape[0], -1, K)
        ties += int(((flat == flat.max(axis=1, keepdims=True)).sum(axis=1) > 1).sum())
        want = np.asarray(j_peaks(y))
        yt = _to_torch(y)
        assert np.array_equal(peaks_from_heatmap(yt).numpy(), want)
        assert np.array_equal(disparity._peaks(yt, None).numpy(), want)
    assert ties > 4 * K, "the maps are meant to hold tied maxima"


@pytest.mark.parametrize("mode", ["min", "max"])
def test_labels_from_bf16_heads_equal_jax(fresh_bf16_heatmaps, mode):
    """The rd_64 / rd_32 / rd_16 labels from tied bfloat16 heatmaps (and, for
    'max', bfloat16 fused targets made as Step B makes them) are float32 and
    within 1e-6 of the JAX package's (``tests/test_pallas_pseudo_label.py``'s
    atol). The fused targets the port builds from the same heads are the
    JAX package's within 2^-6 of their largest value (each is three
    bfloat16 roundings)."""
    out = fresh_bf16_heatmaps
    y = out["y"]
    a2, a3 = out["y_adv2"], out["y_adv3"]
    from dahpe_tpu.core.decode import upsample_bilinear as j_up

    from dahpe_tpu_torch.core.decode import upsample_bilinear

    fused_j = {64: 0.5 * j_up(a3, (HM, HM)) + j_up(a2, (HM, HM)), 32: j_up(a3, (HM // 2,) * 2)}
    assert fused_j[64].dtype == jnp.bfloat16
    fused_t = {64: 0.5 * upsample_bilinear(_to_torch(a3), (HM, HM))
               + upsample_bilinear(_to_torch(a2), (HM, HM)),
               32: upsample_bilinear(_to_torch(a3), (HM // 2,) * 2)}
    assert fused_t[64].dtype == torch.bfloat16
    yt = _to_torch(y)
    cases = [(1, 3.0, "union_minus", 64), (2, 2.0, "inverse", 32), (4, 1.5, "inverse", None)]
    for scale, wf, kind, fuse in cases:
        if scale == 4:
            gt = jdisparity.pseudo_label_gt(y, scale=4, window_factor=1.5)
            want = gt if mode == "min" else jnp.clip(1.0 - gt * 10.0, 0.0, 1.0)
        else:
            # the fused targets of the JAX step: the same bf16 values both sides
            gt, gf = jdisparity._labels(y, scale=scale, window_factor=wf, gf_kind=kind,
                                        fused_target=fused_j[fuse], mode=mode)
            want = gt if mode == "min" else gf
        got = disparity._target(yt, None, scale=scale, window_factor=wf, gf_kind=kind,
                                fused_target=None if fuse is None else _to_torch(fused_j[fuse]),
                                normalize=scale != 4, mode=mode)
        assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=f"{mode} x{scale}")
    # the port's own fused targets (three roundings to bfloat16) are the JAX
    # package's within 2^-6 of their largest value
    for size in (64, 32):
        want = _f32(fused_j[size])
        np.testing.assert_allclose(_f32(fused_t[size]), want, rtol=0,
                                   atol=2 ** -6 * np.abs(want).max(),
                                   err_msg=f"fused target {size}")


# ---------------------------------------------------------------- training

def _jax_da_state(variables, with_ema):
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    return JDATrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt=init_partitioned(torch_sgd(), params, J_DA_PARTITIONS),
        ema_params=params if with_ema else None, ema_batch_stats=stats if with_ema else None,
    )


def _moved(after: dict, before: dict, stats: bool) -> list[np.ndarray]:
    """The change of each parameter (``stats=False``) or BN running
    statistic (``stats=True``), in ``before``'s key order."""
    return [_f32(after[k]) - _f32(before[k]) for k in before
            if k.endswith(("running_mean", "running_var")) == stats
            and not k.endswith("num_batches_tracked")]


def _check_moves(got: dict, ref16: dict, ref32: dict, before: dict, name: str, report):
    for stats, a in ((False, 0.3), (True, 0.02)):
        what = f"{name} {'bn' if stats else 'params'}"
        report.append((what, *assert_bf16(
            _moved(got, before, stats), _moved(ref16, before, stats),
            _moved(ref32, before, stats), a, what)))


@pytest.mark.parametrize("gate,ema", [(None, None), (0.5, 0.99)], ids=["gate-off", "gate-ema"])
def test_two_da_iterations_match_jax_bf16(gate, ema, capsys):
    """Two DA iterations with shared target features, the confidence gate
    off and on: the parameter updates (after − before) within (a) 0.3 and
    (b), the BN statistics' within (a) 0.02 and (b); the parameters stay
    float32. (JAX's own bfloat16 updates lie ~18% of their norm off its
    float32 ones at these weights, hence (a).) The EMA, with the gate, at
    the float32 DA parity tolerance (rtol 5e-3, atol 5e-5)."""
    jm32 = _jax_model("multi", "basic")
    variables = da_variables(jm32, 0, gl_coeff=0.0)
    cfg = dict(share_target_features=True, conf_gate=gate, ema_decay=ema)
    jstates = {}
    for who, dtype in (("j32", None), ("j16", jnp.bfloat16)):
        jstep = jax.jit(j_make_da_train_step(_jax_model("multi", "basic", dtype),
                                             compute_metrics=False, **cfg))
        jstate = _jax_da_state(variables, ema is not None)
        for b_s, b_t in _batches(seed=8):
            jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, b_s),
                              jax.tree.map(jnp.asarray, b_t))
        jstates[who] = jstate
    model = _port_model("multi", "basic", variables, torch.bfloat16)
    state = create_da_state(model, device="cpu", with_ema=ema is not None)
    step = make_da_train_step(model, compute_metrics=True, **cfg)
    for b_s, b_t in _batches(seed=8):
        state, m = step(state, _torch_batch(b_s), _torch_batch(b_t))
        assert m["pred_s"].dtype == m["loss_s"].dtype == torch.float32
    before = state_dict_from_jax(variables)

    def tree(js, prefix=""):
        return state_dict_from_jax({"params": getattr(js, prefix + "params"),
                                    "batch_stats": getattr(js, prefix + "batch_stats")})

    report = []
    _check_moves(model.state_dict(), tree(jstates["j16"]), tree(jstates["j32"]), before,
                 "update", report)
    if ema is not None:
        # the EMA moves by ~1e-2 of the updates, below float32's resolution
        # of the weights (the float32 port's EMA moves are 27% off JAX's):
        # its values are held at the float32 DA parity tolerance instead
        ref = tree(jstates["j16"], "ema_")
        for key, got in state.ema.items():
            np.testing.assert_allclose(got.numpy(), ref[key].numpy(), rtol=5e-3, atol=5e-5,
                                       err_msg=f"ema {key}")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with capsys.disabled():
        print("\n  " + "; ".join(f"{n} (a) {d:.4f} (b) {r:.2f}" for n, d, r in report))


def test_pretrain_step_matches_jax_bf16(capsys):
    """One pretrain step of a bfloat16 ``PoseResNet``: the parameter and BN
    updates within (a) 0.3 / 0.02 and (b), the loss float32."""
    jm32 = _jax_model("pose", "basic")
    variables = da_variables(jm32, 6)
    b_s, _ = _batches(seed=9, n=1)[0]
    refs = {}
    for who, dtype in (("j32", None), ("j16", jnp.bfloat16)):
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = JPretrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                opt=init_partitioned(torch_sgd(), params, J_PRETRAIN_PARTITIONS))
        jstate, _ = jax.jit(j_make_pretrain_step(_jax_model("pose", "basic", dtype)))(
            jstate, jax.tree.map(jnp.asarray, b_s), jnp.float32(0.05))
        refs[who] = state_dict_from_jax({"params": jstate.params,
                                         "batch_stats": jstate.batch_stats})
    model = _port_model("pose", "basic", variables, torch.bfloat16)
    state = create_pretrain_state(model, device="cpu")
    state, m = make_pretrain_step(model)(state, _torch_batch(b_s), 0.05)
    assert m["loss_s"].dtype == torch.float32 and torch.isfinite(m["loss_s"])
    report = []
    _check_moves(model.state_dict(), refs["j16"], refs["j32"], state_dict_from_jax(variables),
                 "pretrain", report)
    with capsys.disabled():
        print("\n  " + "; ".join(f"{n} (a) {d:.4f} (b) {r:.2f}" for n, d, r in report))


def test_chunk_of_three_equals_three_single_calls_bf16():
    """``steps_per_call=3`` of the fused bfloat16 DA iteration leaves the
    state, EMA and generators three single calls leave, and returns their
    mean metrics (the CPU runs both as eager steps: bit for bit)."""
    from dahpe_tpu_torch.data.synthetic import SyntheticHands
    from dahpe_tpu_torch.train import make_fused_da_iteration

    mk = dict(n=8, seed=5, image_size=(IMAGE, IMAGE), heatmap_size=(HM, HM))
    stores = [DeviceDataStore(SyntheticHands(domain=d, split="train", **mk), device="cpu",
                              raw_size=96, verbose=False) for d in ("source", "target")]
    runs = []
    for k, calls in ((1, 3), (3, 1)):
        torch.manual_seed(3)
        model = models.MultiHeadPoseResNet(port_backbone("basic", torch.bfloat16),
                                           num_keypoints=K, dtype=torch.bfloat16)
        state = create_da_state(model, device="cpu", with_ema=True)
        fused = make_fused_da_iteration(model, *stores, B, image_size=IMAGE, heatmap_size=HM,
                                        rotation=30.0, steps_per_call=k, ema_decay=0.99,
                                        conf_gate=0.5)
        gens = [stores[0].generator(7), stores[1].generator(8)]
        metrics = [fused(state, *gens)[1] for _ in range(calls)]
        runs.append((state, metrics, gens))
    (s1, single, g1), (sk, (mk_,), gk) = runs
    assert sk.step == s1.step == int(sk.step_t) == 3
    for name, v in mk_.items():
        assert torch.equal(v, sum(m[name] for m in single) / 3), name
    for (name, a), b in zip(s1.model.state_dict().items(), sk.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, sk.ema[n]) for n, a in s1.ema.items())
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(g1, gk))
    assert mk_["pred_s"].dtype == torch.float32


# ---------------------------------------------------------------- evaluation

def test_validate_matches_jax_bf16():
    """``validate`` of a bfloat16 model over a device-resident split: its
    per-group PCK within (a) 0.05 and (b) of the JAX package's bfloat16
    ``validate``."""
    variables = _variables("multi", "bottleneck", 11)
    source = ArraySource(6, IMAGE, seed=3)
    dataset, jdataset = Hand21KeypointDataset(), JHand21("unused", [])
    jloader = JDeviceDataStore(source, raw_size=IMAGE, verbose=False).eval_loader(
        2, heatmap_size=HM)
    refs = {}
    for who, dtype in (("j32", None), ("j16", jnp.bfloat16)):
        jm = _jax_model("multi", "bottleneck", dtype)
        refs[who] = jevaluate.validate(jloader, jm, variables, jdataset, image_size=IMAGE,
                                       heatmap_size=HM, print_freq=1000)
    model = _port_model("multi", "bottleneck", variables, torch.bfloat16)
    loader = DeviceDataStore(source, device="cpu", raw_size=IMAGE, verbose=False).eval_loader(
        2, heatmap_size=HM)
    got = evaluate.validate(loader, model, dataset, image_size=IMAGE, heatmap_size=HM,
                            print_freq=1000, device="cpu")
    names = sorted(got)
    assert names == sorted(refs["j16"])
    assert_bf16([np.array([got[n] for n in names])],
                [np.array([refs["j16"][n] for n in names], np.float32)],
                [np.array([refs["j32"][n] for n in names], np.float32)], 0.05, "validate pck")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from tests.fixtures import make_h3d_fixture, make_rhd_fixture

    base = tmp_path_factory.mktemp("bf16")
    return (make_rhd_fixture(str(base / "rhd"), n=6, sets=("training", "evaluation")),
            make_h3d_fixture(str(base / "h3d"), n=20))


def test_bf16_artifact_equals_eager_predict_and_checkpoint_pck(roots, tmp_path):
    """``cli.export --bf16`` writes a float32-weight artifact whose program
    computes in bfloat16: its coordinates and confidences equal the
    bfloat16 eager predict's (and differ from the float32 one's), ``cli.serve``
    answers with them, and its ``cli.test --artifact`` PCK equals
    ``cli.test --checkpoint --bf16``."""
    from tests.test_torch_port_cli import _argv

    from dahpe_tpu_torch.cli import export as export_cli
    from dahpe_tpu_torch.cli import test as test_cli
    from dahpe_tpu_torch.cli.args import build_parser
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    torch.manual_seed(0)
    model32 = models.MultiHeadPoseResNet(models.get_backbone("resnet18"), num_keypoints=K)
    checkpoint, out = str(tmp_path / "ckpt"), str(tmp_path / "m.pt2")
    fast_ckpt.save_packed(checkpoint, ckpt.model_tree(model32))
    export_cli.main(export_cli.build_export_parser().parse_args(
        [checkpoint, "-o", out, "-a", "resnet18", "--image-size", str(IMAGE),
         "--heatmap-size", str(HM), "--device", "cpu", "--bf16"]))
    artifact = serving.load_predict_file(out, device="cpu")
    weights = serving.load_artifact_weights(out + ".weights.npz")
    assert all(v.dtype == torch.float32 for v in weights.values() if v.is_floating_point())

    model16 = models.MultiHeadPoseResNet(models.get_backbone("resnet18", torch.bfloat16),
                                         num_keypoints=K, dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    frames = np.random.default_rng(5).standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    coords, maxvals = artifact(weights, torch.from_numpy(frames))
    kw = dict(image_size=IMAGE, heatmap_size=HM, device="cpu")
    eager16 = evaluate.make_predict_fn(model16, **kw)(frames)
    eager32 = evaluate.make_predict_fn(model32, **kw)(frames)
    assert maxvals.dtype == eager16[1].dtype == torch.bfloat16
    assert torch.equal(coords, eager16[0]) and torch.equal(maxvals, eager16[1])
    assert not torch.equal(maxvals.float(), eager32[1])
    # cli.serve answers with the same numbers (its bfloat16 confidences as
    # float32 numpy arrays)
    from dahpe_tpu_torch.cli.serve import build_serve_parser, create_server

    server = create_server(build_serve_parser().parse_args([out, "--port", "0",
                                                            "--device", "cpu"]))
    try:
        served = server.servable.run_arrays(frames)
    finally:
        server.server_close()
    assert np.array_equal(served[0], coords.numpy())
    assert np.array_equal(served[1], maxvals.float().numpy()[..., 0])

    by_artifact = test_cli.main(build_parser("test").parse_args(
        _argv(roots, tmp_path / "a", "--artifact", out)))
    by_checkpoint = test_cli.main(build_parser("test").parse_args(
        _argv(roots, tmp_path / "c", "--checkpoint", checkpoint, "--bf16")))
    assert by_artifact == by_checkpoint
    shutil.rmtree(tmp_path, ignore_errors=True)


# ---------------------------------------------------------------- entry points

def test_train_cli_bf16_resume_is_the_straight_run(roots, tmp_path):
    """``cli.train --bf16 --device-store``: ``--max-steps 1`` then
    ``--resume`` to 2 leaves what a straight run to 2 leaves, bit for bit;
    the saved parameters are float32."""
    from tests.test_torch_port_cli import _argv

    from dahpe_tpu_torch.cli import train as train_cli
    from dahpe_tpu_torch.utils import fast_ckpt

    common = ("--bf16", "--device-store", "--with-ema", "--pretrain-epochs", "0",
              "--epochs", "1")
    a, b = tmp_path / "a", tmp_path / "b"
    assert train_cli.cli_main(_argv(roots, a, *common, "--max-steps", "1")) == 0
    latest = str(a / "checkpoints" / "latest")
    assert train_cli.cli_main(_argv(roots, a, *common, "--max-steps", "2", "--resume",
                                    latest)) == 0
    assert train_cli.cli_main(_argv(roots, b, *common, "--max-steps", "2")) == 0
    resumed = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(latest))
    straight = fast_ckpt.flatten_tree(
        fast_ckpt.load_packed_tree(str(b / "checkpoints" / "latest")))
    assert [p for p, _ in resumed] == [p for p, _ in straight]
    for (path, x), (_, y) in zip(resumed, straight):
        assert torch.equal(x, y), path
        assert not x.is_floating_point() or x.dtype == torch.float32, path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_adaptation_experiment_runs_in_bf16():
    """``run_adaptation_experiment(bf16=True)``: a ``micro`` 2+2 run returns
    the full result dict."""
    from dahpe_tpu_torch.experiments import adaptation

    r = adaptation.run_adaptation_experiment(
        arch="micro", n_train=8, n_val=8, batch=4, pre_iters=2, da_iters=2, eval_every=2,
        conf_gate=0.5, seed=1, bf16=True, device="cpu", verbose=False)
    assert set(r) == {"shift", "content", "style", "source_val", "pretrain", "source_only",
                      "da", "gain", "curve", "da_seconds", "da_ema"}
    for key in ("source_val", "pretrain", "source_only", "da", "da_ema"):
        assert 0.0 <= r[key] <= 1.0, key
