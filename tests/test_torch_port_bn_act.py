"""PyTorch port, ``dahpe_tpu_torch.ops.batch_norm_act`` on the CPU.

- The op's plain path is the module sequence it replaced (``bn``, the add,
  the in-place ReLU) bit for bit: the output, ``dx``, ``dweight``,
  ``dbias``, the residual's gradient and the running statistics, in float32
  and bfloat16, for its three forms.
- The dispatch takes the kernels only for a training forward with local
  statistics of a CUDA bfloat16 tensor: the CPU, float32, eval mode and the
  cross-rank layer run the plain path.
- The models call it without changing a state-dict key or a module.
- With the tracer on it counts every batch norm call of a forward
  (``bn_act.plain`` here), and with it off nothing.
- The kernels' tiling (``plan``) covers every batch-norm shape of the bf16
  model at batch 32 once, in a grid the card holds at once (two blocks an
  SM), which both ends of its range fill.

The kernels themselves (``csrc/batch_norm_act.cu``) run on the card only:
``chip_smoke.py`` phase 2 holds them to ``batch_norm_act_plain`` there.
"""

import copy
import hashlib
import types

import pytest
import torch
from torch import nn

from dahpe_tpu_torch import models
from dahpe_tpu_torch.models.batch_norm import BatchNorm2d
from dahpe_tpu_torch.ops import batch_norm_act as bna
from dahpe_tpu_torch.utils import profiling

FORMS = {"relu_residual": (True, True), "relu": (True, False), "bn": (False, False)}


def _layer(channels, seed):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(channels)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(channels, generator=g))
        bn.bias.copy_(0.1 * torch.randn(channels, generator=g))
        bn.running_mean.copy_(0.5 * torch.randn(channels, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(channels, generator=g))
    return bn.train()


def _nhwc(shape, dtype, seed, scale=1.0, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(n, h, w, c, generator=g) * scale + shift
    return x.to(dtype).permute(0, 3, 1, 2)  # channels-last, as the models' activations


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_path_is_the_module_sequence(dtype, form):
    relu, with_residual = FORMS[form]
    shape = (3, 24, 5, 7)
    bn_op = _layer(24, 1)
    bn_seq = copy.deepcopy(bn_op)
    x = _nhwc(shape, dtype, 2, scale=2.0, shift=0.3)
    r = _nhwc(shape, dtype, 3) if with_residual else None
    dy = _nhwc(shape, dtype, 4)

    def run(fn, bn):
        xi = x.detach().clone().requires_grad_(True)
        ri = None if r is None else r.detach().clone().requires_grad_(True)
        y = fn(xi, bn, ri)
        y.backward(dy)
        return y.detach(), xi.grad, bn.weight.grad, bn.bias.grad, \
            None if ri is None else ri.grad

    def sequence(xi, bn, ri):  # the blocks' and heads' code before the op
        out = bn(xi)
        if ri is not None:
            out = out + ri
        return nn.ReLU(inplace=True)(out) if relu else out

    got = run(lambda xi, bn, ri: bna.batch_norm_act(xi, bn, relu=relu, residual=ri), bn_op)
    want = run(sequence, bn_seq)
    assert got[0].dtype == dtype and (got[4] is None) == (not with_residual)
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "dresidual"), got, want):
        if b is None:
            assert a is None, name
        else:
            assert torch.equal(a, b), name
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn_op, name), getattr(bn_seq, name)), name
    assert int(bn_op.num_batches_tracked) == 1


def _fake(is_cuda, dtype):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)


@pytest.mark.parametrize("case, x, training, cross_rank, kernel", [
    ("card_bf16_train", _fake(True, torch.bfloat16), True, False, True),
    ("cpu_bf16_train", _fake(False, torch.bfloat16), True, False, False),
    ("card_f32_train", _fake(True, torch.float32), True, False, False),
    ("card_bf16_eval", _fake(True, torch.bfloat16), False, False, False),
    ("card_bf16_cross_rank", _fake(True, torch.bfloat16), True, True, False),
], ids=lambda v: v if isinstance(v, str) else "")
def test_dispatch_takes_the_kernels_only_for_bf16_training_on_a_card(
        case, x, training, cross_rank, kernel):
    bn = _layer(8, 0).train(training)
    bn._cross_rank = cross_rank
    assert bna.takes_kernel(x, bn) is kernel, case


def test_a_residual_needs_the_relu():
    bn = _layer(4, 0)
    x = _nhwc((2, 4, 3, 3), torch.float32, 1)
    with pytest.raises(ValueError, match="ReLU"):
        bna.batch_norm_act(x, bn, relu=False, residual=x)


def _resnet101_meta(dtype=torch.bfloat16):
    with torch.device("meta"):
        return models.MultiHeadPoseResNet(models.resnet101(dtype=dtype), num_keypoints=21,
                                          dtype=dtype)


def _digest(lines):
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def test_state_dict_keys_and_modules_unchanged():
    """The op replaced calls, not modules: the state-dict keys with their
    shapes and the module tree (names and types) of the bf16
    ``MultiHeadPoseResNet(resnet101)`` are those the models had before it
    (digests taken there), and every BN keeps its ReLU module."""
    model = _resnet101_meta()
    state = model.state_dict()
    assert len(state) == 724
    assert _digest(f"{k} {tuple(v.shape)}" for k, v in state.items()) == (
        "3a17e89312d3437569d312e3b5edffe36aff72ca56a38aa5c79c59be28d7d2b6")
    assert _digest(f"{n} {type(m).__name__}" for n, m in model.named_modules()) == (
        "2c51d78110e33e13d96f87da213f861b18f4d919d50e268c541a28141da1849d")
    kinds = [type(m) for m in model.modules()]
    assert kinds.count(BatchNorm2d) == 117 and kinds.count(nn.ReLU) == 47


def _bn_calls(model):
    calls = []
    hooks = [m.register_forward_hook(lambda mod, i, o: calls.append(tuple(i[0].shape)))
             for m in model.modules() if isinstance(m, BatchNorm2d)]
    return calls, hooks


def test_tracer_counts_every_batch_norm_call_of_a_forward():
    torch.manual_seed(0)
    model = models.MultiHeadPoseResNet(models.ResNet(models.Bottleneck, [1, 1, 1, 1]),
                                       num_keypoints=5, feature_dim=16).train()
    x = torch.randn(2, 32, 32, 3)
    calls, hooks = _bn_calls(model)
    try:
        before = profiling.counters()
        with torch.no_grad():
            model(x)  # tracer off: nothing counted
        assert profiling.counters() == before and len(calls) > 0
        n_off, calls[:] = len(calls), []
        profiling.enable(True)
        with torch.no_grad():
            model(x)
        after = profiling.counters()
    finally:
        profiling.enable(False)
        for h in hooks:
            h.remove()
    assert len(calls) == n_off
    assert after.get("bn_act.plain", 0) - before.get("bn_act.plain", 0) == len(calls)
    assert after.get("bn_act.kernel", 0) == before.get("bn_act.kernel", 0)


def _model_bn_shapes(batch=32, size=256):
    """``(rows, channels)`` of every batch norm call of the bf16 model's DA
    forward (features, main head, adversarial heads) at ``batch``."""
    model = _resnet101_meta().train()
    calls, hooks = _bn_calls(model)
    with torch.no_grad():
        model(torch.empty(batch, size, size, 3, device="meta"))
    for h in hooks:
        h.remove()
    return sorted({(n * h * w, c) for n, c, h, w in calls})


@pytest.mark.parametrize("vec", [8, 1])
def test_plan_covers_every_model_shape_once(vec):
    sms = 132
    shapes = _model_bn_shapes()
    assert (524288, 64) in shapes and (2048, 2048) in shapes and len(shapes) == 12
    for rows, channels in shapes + [(3 * 35, 24), (7, 40), (2, 8), (1000, 2056)]:
        p = bna.plan(rows, channels, vec, sms)
        label = (rows, channels, p)
        assert p.ct * p.rpp <= bna.THREADS, label
        # every row in one block's run, no block without rows
        assert p.row_blocks * p.rows_per_block >= rows > (p.row_blocks - 1) * p.rows_per_block, label
        # every channel vector in one block's tile, no block without channels
        cvec = channels // vec
        assert p.ch_blocks * p.ct >= cvec > (p.ch_blocks - 1) * p.ct, label
        # a cooperative grid: every block resident, two an SM
        assert p.row_blocks * p.ch_blocks <= bna.BLOCKS_PER_SM * sms, label
    for rows, channels in ((524288, 64), (2048, 2048)):  # the stem, layer4's widest
        p = bna.plan(rows, channels, 8, sms)
        assert p.row_blocks * p.ch_blocks == 2 * sms, (rows, channels, p)
