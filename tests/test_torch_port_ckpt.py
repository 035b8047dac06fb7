"""PyTorch port, checkpoints: the packed format of
``dahpe_tpu_torch.utils.fast_ckpt`` (exact round trips, the JAX package's
layout read both ways, crash-safe swaps, the asynchronous saver's ordering,
snapshots, supersession and errors) and ``utils/checkpoint.py`` (a DA state
with momentum and EMA restored so that training continues bit-identically,
and the JAX package's packed checkpoints and reference ``.pth`` files as
warm starts).

Forwards through carried weights are held to
``tests/test_torch_port_models.py``'s tolerance (rtol 2e-3, atol
max(2e-4, 1e-4·std)); everything else is exact.
"""

import copy
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahpe_tpu import models as jmodels
from dahpe_tpu.utils import checkpoint as jckpt
from dahpe_tpu.utils import fast_ckpt as jfast_ckpt
from tests.test_torch_port_models import (
    assert_forward_close,
    jax_backbone,
    model_pair,
    port_backbone,
    randomize_variables,
)

from dahpe_tpu_torch import models
from dahpe_tpu_torch.cli.train import _load_warm_start
from dahpe_tpu_torch.train import create_da_state, make_da_train_step
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils import fast_ckpt
from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax


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


def small_tree(offset=0):
    return {
        "model": {"conv.weight": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + offset,
                  "bn.num_batches_tracked": torch.tensor(3 + offset, dtype=torch.int64)},
        "half": torch.arange(5, dtype=torch.bfloat16) / 3 + offset,
        "bytes": torch.arange(16, dtype=torch.uint8) + offset,
        "step": torch.tensor(7 + offset, dtype=torch.int64),
    }


def assert_trees_equal(a, b):
    fa, fb = fast_ckpt.flatten_tree(a), fast_ckpt.flatten_tree(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_packed_round_trip_exact(tmp_path):
    tree = small_tree()
    p = str(tmp_path / "ck")
    fast_ckpt.save_packed(p, tree)
    assert fast_ckpt.is_packed(p)
    assert_trees_equal(tree, fast_ckpt.load_packed_tree(p))
    assert_trees_equal(tree, fast_ckpt.restore_packed(p, small_tree(offset=1)))


def test_packed_layout_is_the_jax_packages(tmp_path):
    """The JAX package reads the port's checkpoints (bfloat16 through its
    uint16 storage) and the port reads the JAX package's."""
    p = str(tmp_path / "port")
    fast_ckpt.save_packed(p, small_tree())
    theirs = jfast_ckpt.load_packed_tree(p)
    np.testing.assert_array_equal(theirs["model"]["conv.weight"],
                                  small_tree()["model"]["conv.weight"].numpy())
    np.testing.assert_array_equal(np.asarray(theirs["half"], np.float32),
                                  small_tree()["half"].float().numpy())
    jtree = {"params": {"conv": {"kernel": jnp.arange(24, dtype=jnp.float32).reshape(2, 3, 4)},
                        "bn": {"scale": jnp.arange(5, dtype=jnp.bfloat16) / 3}},
             "step": jnp.asarray(9, jnp.int32)}
    q = str(tmp_path / "jax")
    jfast_ckpt.save_packed(q, jtree)
    ours = fast_ckpt.load_packed_tree(q)
    assert ours["params"]["bn"]["scale"].dtype == torch.bfloat16
    assert torch.equal(ours["params"]["bn"]["scale"], small_tree()["half"])
    np.testing.assert_array_equal(ours["params"]["conv"]["kernel"].numpy(),
                                  np.asarray(jtree["params"]["conv"]["kernel"]))
    assert int(ours["step"]) == 9


def test_template_mismatch_is_a_hard_error(tmp_path):
    p = str(tmp_path / "ck")
    fast_ckpt.save_packed(p, small_tree())
    other = small_tree()
    other["model"]["conv.weight"] = torch.zeros(3, 3, 4)
    with pytest.raises(ValueError, match="mismatch"):
        fast_ckpt.restore_packed(p, other)
    del other["bytes"]
    with pytest.raises(ValueError):
        fast_ckpt.restore_packed(p, other)


def test_restore_survives_crash_inside_swap_window(tmp_path):
    p = str(tmp_path / "latest")
    fast_ckpt.save_packed(p, small_tree())
    os.rename(p, p + ".old_pack")  # killed between the two renames
    assert fast_ckpt.resolve_packed(p) == p + ".old_pack"
    assert_trees_equal(small_tree(), fast_ckpt.load_packed_tree(p))
    fast_ckpt.save_packed(str(tmp_path / "t2"), small_tree(1))
    os.rename(str(tmp_path / "t2"), p + ".tmp_pack")  # a complete tmp wins
    assert int(fast_ckpt.load_packed_tree(p)["step"]) == 8
    # the next save promotes the stranded tmp instead of destroying it
    assert not fast_ckpt._drain_write(p, fast_ckpt.pack_state(small_tree(2)), alive=lambda: False)
    assert int(fast_ckpt.load_packed_tree(p)["step"]) == 8


def test_async_saver_orders_save_link_aux_prune(tmp_path):
    saver = fast_ckpt.AsyncSaver()
    ckdir = tmp_path / "checkpoints"
    ckdir.mkdir()
    for epoch in range(3):
        p = str(ckdir / str(epoch))
        saver.save(p, small_tree(epoch))
        saver.save_aux(p, best_acc=float(epoch), key_s=torch.Generator().manual_seed(epoch)
                       .get_state())
    saver.link(str(ckdir / "2"), str(ckdir / "best"))
    saver.run(lambda: ckpt.prune_epoch_checkpoints(str(ckdir), 1))
    saver.close()
    assert sorted(os.listdir(ckdir)) == ["2", "2_aux.npz", "best"]
    assert_trees_equal(small_tree(2), fast_ckpt.load_packed_tree(str(ckdir / "best")))
    aux = ckpt.load_aux(str(ckdir / "2"))
    assert float(aux["best_acc"]) == 2.0
    g = torch.Generator()
    g.set_state(torch.from_numpy(aux["key_s"]))
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(2)))


def test_async_saver_snapshot_survives_in_place_updates(tmp_path):
    """The port's optimizers update in place: what is saved is the state at
    ``save()``, not what the tensors hold when the worker writes."""
    saver = fast_ckpt.AsyncSaver()
    gate = threading.Event()
    saver.run(gate.wait)  # hold the worker until the tensors have changed
    tree = small_tree()
    p = str(tmp_path / "ck")
    saver.save(p, tree)
    with torch.no_grad():
        tree["model"]["conv.weight"].add_(100.0)
        tree["step"].fill_(0)
    gate.set()
    saver.close()
    assert_trees_equal(small_tree(), fast_ckpt.load_packed_tree(p))


def test_async_saver_same_path_supersession(tmp_path):
    """The newest save to a path wins; a superseded one is abandoned only
    once a complete checkpoint exists there."""
    saver = fast_ckpt.AsyncSaver(max_pending=8)
    p = str(tmp_path / "latest")
    for first, second in ((0, 1), (10, 20)):
        gate = threading.Event()
        saver.run(gate.wait)
        saver.save(p, small_tree(first))
        saver.save(p, small_tree(second))
        gate.set()
        saver.flush()
        assert int(fast_ckpt.load_packed_tree(p)["step"]) == 7 + second
    saver.close()


def test_async_saver_surfaces_worker_errors(tmp_path):
    saver = fast_ckpt.AsyncSaver()
    saver.run(lambda: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(RuntimeError, match="disk full"):
        saver.flush()
    p = str(tmp_path / "ck")  # usable after the error is surfaced
    saver.save(p, small_tree())
    saver.close()
    assert fast_ckpt.is_packed(p)


def _mini_model(seed=0):
    torch.manual_seed(seed)
    return models.MultiHeadPoseResNet(port_backbone("bottleneck"), num_keypoints=21)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((b, 64, 64, 3)).astype(np.float32)),
            "target": torch.from_numpy(rng.uniform(size=(b, 16, 16, 21)).astype(np.float32)),
            "weight": torch.ones(b, 21)}


def _state_and_step(seed=0):
    model = _mini_model(seed)
    state = create_da_state(model, device="cpu", with_ema=True)
    return state, make_da_train_step(model, ema_decay=0.99)


@pytest.mark.parametrize("steps", [0, 2], ids=["never-stepped", "stepped"])
def test_da_state_round_trip_continues_bit_identically(tmp_path, steps):
    """Weights, BN statistics and counters, the five momentum buffers (zeros
    for partitions never stepped), the step and the EMA survive a save and
    restore exactly, and the next iteration gives identical results."""
    state, step = _state_and_step()
    for i in range(steps):
        state, _ = step(state, _batch(i), _batch(100 + i))
    p = str(tmp_path / "state")
    ckpt.save_state(p, state)
    other, other_step = _state_and_step(seed=1)
    ckpt.restore_state(p, other)
    assert other.step == state.step == steps
    assert_trees_equal(ckpt.state_tree(state), ckpt.state_tree(other))
    _, m1 = step(state, _batch(7), _batch(8))
    _, m2 = other_step(other, _batch(7), _batch(8))
    assert float(m1["loss_s"]) == float(m2["loss_s"])
    assert_trees_equal(ckpt.state_tree(state), ckpt.state_tree(other))


def test_jax_packed_checkpoint_gives_the_jax_forward(tmp_path):
    """A JAX-package checkpoint (``fast_ckpt.save_packed`` of its variables)
    read template-free by the port reproduces the JAX model's forward."""
    jmodel, variables, model = model_pair("bottleneck", seed=5)
    p = str(tmp_path / "jax_ckpt")
    jfast_ckpt.save_packed(p, variables)
    fresh = _mini_model(3).eval()
    fresh.load_state_dict(ckpt.load_model_variables(p))
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False, gl_coeff=0.0)
    with torch.no_grad():
        out = fresh(torch.from_numpy(x))
    for name in ("y", "y_adv", "y_adv2", "y_adv3"):
        assert_forward_close(out[name].numpy(), ref[name], name)


def test_reference_pth_round_trips_between_the_packages(tmp_path):
    """A ``.pth`` written by the JAX package loads strictly into the port
    with the JAX forward, and one the port writes loads strictly into the
    JAX package."""
    jmodel, variables, _ = model_pair("bottleneck", seed=6)
    p = str(tmp_path / "jax.pth")
    jckpt.save_reference_pth(p, variables)
    model = _mini_model(4).eval()
    ckpt.load_reference_pth(p, model, strict=True)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False, gl_coeff=0.0)
    with torch.no_grad():
        assert_forward_close(model(torch.from_numpy(x))["y"].numpy(), ref["y"], "y")
    q = str(tmp_path / "port.pth")
    ckpt.save_reference_pth(q, model)
    back = jckpt.load_reference_pth(q, variables, strict=True)
    want = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_pretrain_checkpoint_warm_starts_the_da_model(tmp_path):
    """``--pretrain`` with a JAX ``PoseResNet`` checkpoint: backbone and
    upsampling come from it, the pretrain head's keys are dropped, the
    multi-head model's heads keep their weights."""
    jpose = jmodels.PoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=21)
    shapes = jax.eval_shape(
        lambda key: jpose.init(key, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.key(0))
    variables = randomize_variables(shapes, 8)
    p = str(tmp_path / "pretrain")
    jfast_ckpt.save_packed(p, variables)
    model = _mini_model(2)
    before = copy.deepcopy(model.state_dict())
    _load_warm_start(model, p)
    carried = state_dict_from_jax(variables)
    after = model.state_dict()
    moved = 0
    for key, value in after.items():
        if key.startswith(("backbone.", "upsampling.")):
            assert torch.equal(value, carried[key]), key
            moved += 1
        else:
            assert torch.equal(value, before[key]), key
    assert moved > 50


def test_load_imagenet_backbone(tmp_path):
    """A torchvision-keyed file (no ``backbone.`` prefix, an ``fc``
    classifier) fills the backbone only."""
    src = _mini_model(9)
    sd = {k[len("backbone."):]: v for k, v in src.state_dict().items() if k.startswith("backbone.")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    p = str(tmp_path / "imagenet.pth")
    torch.save(sd, p)
    model = _mini_model(10)
    head = copy.deepcopy(model.head.state_dict())
    ckpt.load_imagenet_backbone(p, model)
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k, v in model.head.state_dict().items():
        assert torch.equal(v, head[k]), k


def test_load_model_variables_refuses_other_directories(tmp_path):
    with pytest.raises(ValueError, match="not a packed checkpoint"):
        ckpt.load_model_variables(str(tmp_path))
    p = str(tmp_path / "other")
    fast_ckpt.save_packed(p, {"weights": torch.zeros(2)})
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_model_variables(p)


def test_prune_epoch_checkpoints(tmp_path):
    for name in ("0", "1", "2", "best", "model_ema"):
        os.makedirs(tmp_path / name)
    for epoch in range(3):
        (tmp_path / f"{epoch}_aux.npz").write_bytes(b"")
    assert ckpt.prune_epoch_checkpoints(str(tmp_path), 1) == [0, 1]
    assert sorted(os.listdir(tmp_path)) == ["2", "2_aux.npz", "best", "model_ema"]
