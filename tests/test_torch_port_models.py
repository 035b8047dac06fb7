"""PyTorch port, models: ``dahpe_tpu_torch.models`` against ``dahpe_tpu``'s
Flax modules on the same weights and inputs.

Weights are made with numpy (fan-in scaled, as
``tests/test_full_model_parity.py`` makes them, so activations stay O(1) and
an import bug cannot hide behind near-zero outputs), initialised into the
Flax tree and carried to the port by ``state_dict_from_jax``.

Tolerances are ``tests/test_full_model_parity.py:119-124``'s: rtol 2e-3 and
atol ``max(2e-4, 1e-4·std)``, because float32 convolutions accumulate in
another order in torch and XLA and the difference grows with depth.
"""

from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.models import resnet as jresnet
from dahpe_tpu.models import upsampling as jupsampling
from dahpe_tpu.utils.torch_import import export_torch_state_dict

from dahpe_tpu_torch import models
from dahpe_tpu_torch.utils.torch_import import load_pth, state_dict_from_jax

OUTPUTS = ("y", "f", "y_adv", "y_adv2", "y_adv3")


def _map_tree(fn, tree, path=()):
    return {
        k: _map_tree(fn, v, path + (k,)) if isinstance(v, Mapping) else fn(path + (k,), v)
        for k, v in tree.items()
    }


def randomize_variables(variables, seed):
    """Fan-in-scaled numpy weights and random BN stats for a Flax tree."""
    rng = np.random.default_rng(seed)

    def param(path, v):
        shape = np.shape(v)
        if path[-1] == "kernel":
            std = (2.0 / int(np.prod(shape[:-1]))) ** 0.5
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if path[-1] == "scale":  # BN scale near 1; damp residual branch ends
            s = 1.0 + 0.2 * rng.standard_normal(shape)
            return (s * (0.2 if path[-2] == "bn3" else 1.0)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def stat(path, v):
        if path[-1] == "mean":
            return (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
        return (rng.uniform(size=np.shape(v)) + 0.5).astype(np.float32)

    return {
        "params": _map_tree(param, variables["params"]),
        "batch_stats": _map_tree(stat, variables["batch_stats"]),
    }


def jax_backbone(kind, dtype=None):
    block = jresnet.BasicBlock if kind == "basic" else jresnet.Bottleneck
    return jmodels.ResNet(block=block, layers=[1, 1, 1, 1], dtype=dtype)


def port_backbone(kind, dtype=None):
    block = models.BasicBlock if kind == "basic" else models.Bottleneck
    return models.ResNet(block, [1, 1, 1, 1], dtype=dtype)


def model_pair(kind="bottleneck", *, image_size=64, seed=0):
    """A mini JAX ``MultiHeadPoseResNet`` with random numpy weights, and the
    port's model carrying the same weights (eval mode, on the CPU)."""
    jmodel = jmodels.MultiHeadPoseResNet(backbone=jax_backbone(kind), num_keypoints=21)
    x0 = jnp.zeros((1, image_size, image_size, 3), jnp.float32)
    # only the tree's shapes are used: tracing them is ~20x faster than an
    # eager init on the CPU
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, x0, train=False, gl_coeff=0.0), jax.random.key(0)
    )
    variables = randomize_variables(shapes, seed)
    model = models.MultiHeadPoseResNet(port_backbone(kind), num_keypoints=21)
    model.load_state_dict(state_dict_from_jax(variables))
    return jmodel, variables, model.eval()


def assert_forward_close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    atol = max(2e-4, 1e-4 * float(np.abs(ref).std()))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=atol, err_msg=name)


@pytest.fixture(scope="module", params=["bottleneck", "basic"])
def pair(request):
    return (request.param, *model_pair(request.param))


def test_state_dict_carrier_matches_jax_export(pair):
    """The port's own carrier equals the JAX package's torch exporter, and
    loads into the port's model with every key used (strict)."""
    _, _, variables, model = pair
    ours = state_dict_from_jax(variables)
    theirs = export_torch_state_dict(variables)
    assert set(ours) == set(theirs) == set(model.state_dict())
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
        assert tuple(model.state_dict()[key].shape) == tuple(np.shape(value)), key


def test_eval_forward_all_outputs_match_jax(pair):
    kind, jmodel, variables, model = pair
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False, gl_coeff=0.0)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert set(out) == set(OUTPUTS)
    for name in OUTPUTS:
        assert_forward_close(out[name].numpy(), ref[name], f"{kind}/{name}")
    assert tuple(out["y"].shape) == (2, 16, 16, 21)
    assert tuple(out["y_adv3"].shape) == (2, 4, 4, 21)
    assert np.abs(out["y"].numpy()).std() > 1e-2  # weights are not degenerate


def test_train_forward_and_bn_stats_match_jax():
    jmodel, variables, model = model_pair("bottleneck", seed=3)
    x = np.random.default_rng(2).standard_normal((4, 64, 64, 3)).astype(np.float32)
    ref, updated = jmodel.apply(
        variables, jnp.asarray(x), train=True, gl_coeff=0.1, mutable=["batch_stats"]
    )
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x), gl_coeff=0.1)
    for name in OUTPUTS:
        assert_forward_close(out[name].numpy(), ref[name], f"train/{name}")
    new_state = state_dict_from_jax({"batch_stats": updated["batch_stats"]})
    state = model.state_dict()
    for key, value in new_state.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                state[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-5, err_msg=key
            )


def test_pose_resnet_matches_jax():
    jmodel = jmodels.PoseResNet(backbone=jax_backbone("basic"), num_keypoints=21)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = randomize_variables(
        jmodel.init(jax.random.key(0), jnp.asarray(x), train=False), 5
    )
    model = models.PoseResNet(port_backbone("basic"), num_keypoints=21)
    model.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert_forward_close(got, jmodel.apply(variables, jnp.asarray(x), train=False), "pose")


def test_grouped_bottleneck_backbone_matches_jax():
    """ResNeXt geometry (groups=32, base_width=4) on a mini depth."""
    jnet = jmodels.ResNet(block=jresnet.Bottleneck, layers=[1, 1, 1, 1],
                          groups=32, base_width=4)
    x = np.random.default_rng(6).standard_normal((1, 64, 64, 3)).astype(np.float32)
    variables = randomize_variables(jnet.init(jax.random.key(0), jnp.asarray(x)), 7)
    net = models.ResNet(models.Bottleneck, [1, 1, 1, 1], groups=32, base_width=4)
    net.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_forward_close(got.numpy(), jnet.apply(variables, jnp.asarray(x)), "resnext")


@pytest.mark.parametrize("k", [2, 3, 4])
def test_deconv_geometry_matches_jax(k):
    jup = jupsampling.Upsampling(hidden_dims=(8, 8, 8), kernel_sizes=(k, k, k))
    x = np.random.default_rng(k).standard_normal((2, 4, 4, 16)).astype(np.float32)
    variables = randomize_variables(
        jup.init(jax.random.key(0), jnp.asarray(x), train=False), k
    )
    up = models.Upsampling(16, (8, 8, 8), (k, k, k))
    state = state_dict_from_jax({"params": {"upsampling": variables["params"]},
                                 "batch_stats": {"upsampling": variables["batch_stats"]}})
    up.load_state_dict({key.split(".", 1)[1]: v for key, v in state.items()})
    with torch.no_grad():
        got = up.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 32, 32, 8)
    assert_forward_close(got.numpy(), jup.apply(variables, jnp.asarray(x), train=False),
                         f"deconv k={k}")


def test_load_pth_round_trip(pair, tmp_path):
    """A reference-style ``{"model": state_dict}`` checkpoint loads into the
    port with a plain ``load_state_dict``."""
    _, _, variables, model = pair
    path = tmp_path / "ckpt.pth"
    torch.save({"model": state_dict_from_jax(variables), "epoch": 3}, path)
    state = load_pth(str(path))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    bare = tmp_path / "bare.pth"
    torch.save(model.state_dict(), bare)
    for key, value in load_pth(str(bare), key=None).items():
        assert torch.equal(value, state[key]), key


def test_backbone_registry():
    assert set(models.BACKBONES) == set(jmodels.BACKBONES)
    assert models.get_backbone("resnet18").out_features == 512
    assert models.get_backbone("resnet50").out_features == 2048
    with pytest.raises(ValueError):
        models.get_backbone("vgg16")
    depth = sum(len(getattr(models.resnet101(), f"layer{i}")) for i in range(1, 5))
    assert depth == 3 + 4 + 23 + 3


def test_initialisation_matches_jax():
    """A freshly built port model starts from the JAX package's initial
    distributions (``init``), key by key: ResNet convs Kaiming-normal
    fan_out truncated at 2σ (``dahpe_tpu/models/resnet.py:21``), head and
    deconv kernels N(0, 1e-3²) with zero biases (``heads.py:9``,
    ``upsampling.py:20``), BN ones and zeros. Each port tensor's standard
    deviation is within 10% of JAX's (tensors of 2048+ entries), no entry
    lies beyond the truncation (backbone) or 6σ (heads), and the zeros and
    ones are where JAX's are. Training from scratch (the adaptation
    experiment, the CLI without ``--imagenet-pth``) starts where the JAX
    package starts."""
    jmodel = jmodels.MultiHeadPoseResNet(backbone=jax_backbone("basic"), num_keypoints=21)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    torch.manual_seed(0)
    got = models.MultiHeadPoseResNet(port_backbone("basic"), num_keypoints=21).state_dict()
    assert set(want) <= set(got)
    for key, w in want.items():
        g, w = got[key].double(), w.double()
        if torch.all(w == w.flatten()[0]):  # zeros and ones: BN, biases, statistics
            assert torch.equal(g, w), key
            continue
        if w.numel() >= 2048:
            np.testing.assert_allclose(float(g.std()), float(w.std()), rtol=0.1, err_msg=key)
        if key.startswith("backbone"):
            fan_out = g.shape[0] * g[0, 0].numel()
            bound = 2 * (2.0 / fan_out) ** 0.5 / 0.87962566103423978
        else:
            bound = 6e-3
        assert float(g.abs().max()) <= bound * (1 + 1e-6), key
