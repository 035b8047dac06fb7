"""Training batch norm with the ReLU and the residual add that follow it:
the CUDA kernels for bfloat16 channels-last activations, and the plain
sequence they replace.

Replaces no TPU kernel. :func:`batch_norm_act` computes one of

    relu(bn(x) + residual),  relu(bn(x)),  bn(x)

for a :class:`~dahpe_tpu_torch.models.batch_norm.BatchNorm2d` ``bn``. It
takes the kernels (``dahpe_tpu_torch/csrc/batch_norm_act.cu``, whose header
says what bounds them and how the design answers that) only for a training
forward with local statistics on a CUDA bfloat16 tensor
(:func:`takes_kernel`); everything else runs :func:`batch_norm_act_plain`,
the module sequence itself: float32 models keep cuDNN's batch norm, eval
mode (serving, export, tests) ATen's, the cross-rank layer its own.

On the kernel path the statistics and the parameters are float32 and the
activations bfloat16, as in the plain sequence, and the output rounds where
it rounds (the batch norm's output, then the sum, then the ReLU), so with
equal statistics the two give the same bits. The running statistics and
``num_batches_tracked`` move as ``nn.BatchNorm2d`` moves them. The library
is built at the first call that takes the kernels.

With the tracer on (``utils.profiling.enable``) every call counts
``bn_act.kernel`` or ``bn_act.plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from dahpe_tpu_torch.ops import _build
from dahpe_tpu_torch.utils import profiling

LIB_NAME = "batch_norm_act"
SOURCES = ["batch_norm_act.cu"]
THREADS = 256  # a block (csrc/batch_norm_act.cu)
TILE_VECTORS = 32  # channel vectors a block spans at most: a warp's 512 bytes
BLOCKS_PER_SM = 2  # blocks resident on an SM: a cooperative grid's ceiling
MIN_PASSES = 2  # row passes a thread makes at least
MODES = {(False, False): 0, (True, False): 1, (True, True): 2}  # (relu, residual) -> mode

# kernel launches (one a forward, one a backward) since the last reset
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME, SOURCES)
    if lib.batch_norm_act_forward.argtypes is None:
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.batch_norm_act_forward.argtypes = [p] * 11 + [i] * 9 + [d, d, p]
        lib.batch_norm_act_forward.restype = ctypes.c_int
        lib.batch_norm_act_backward.argtypes = [p] * 13 + [i] * 9 + [p]
        lib.batch_norm_act_backward.restype = ctypes.c_int
    return lib


def batch_norm_act_plain(x: torch.Tensor, bn, *, relu: bool,
                         residual: torch.Tensor | None = None) -> torch.Tensor:
    """The module sequence: ``bn(x)``, then ``+ residual``, then an in-place
    ReLU, as the blocks and heads ran it before the fused op."""
    y = bn(x)
    if residual is not None:
        y = y + residual
    return torch.relu_(y) if relu else y


def takes_kernel(x, bn) -> bool:
    """Whether :func:`batch_norm_act` launches the kernels for ``x``: a
    training forward with local statistics of a CUDA bfloat16 tensor."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and bn.training
            and not getattr(bn, "_cross_rank", False))


class Plan(NamedTuple):
    """How every pass of ``csrc/batch_norm_act.cu`` tiles ``rows x channels``:
    ``vec`` channels a thread (8: one 16-byte access), blocks of ``ct``
    vectors by ``rpp`` rows, ``ch_blocks`` along the channels and
    ``row_blocks`` runs of ``rows_per_block`` rows."""

    vec: int
    ct: int
    rpp: int
    row_blocks: int
    ch_blocks: int
    rows_per_block: int


@functools.lru_cache(maxsize=256)
def plan(rows: int, channels: int, vec: int, sms: int) -> Plan:
    """The tiling of ``rows x channels`` for a card of ``sms`` SMs: at most
    ``BLOCKS_PER_SM`` blocks an SM (the kernels' grid is cooperative: every
    block resident), each thread at least ``MIN_PASSES`` row passes where
    the rows allow. (Beyond ``BLOCKS_PER_SM * sms`` channel tiles, 67,584
    channels on an H100, the launch is refused.)"""
    cvec = channels // vec
    ct = min(cvec, TILE_VECTORS)
    rpp = THREADS // ct
    ch_blocks = -(-cvec // ct)
    passes = -(-rows // rpp)
    row_blocks = max(1, min(BLOCKS_PER_SM * sms // ch_blocks, passes // MIN_PASSES))
    rows_per_block = -(-rows // row_blocks)
    return Plan(vec, ct, rpp, -(-rows // rows_per_block), ch_blocks, rows_per_block)


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(*tensors: torch.Tensor) -> Plan:
    x = tensors[0]
    channels = x.shape[1]
    rows = x.numel() // channels
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    vec = 8 if channels % 8 == 0 and aligned else 1
    return plan(rows, channels, vec, _sms(x.device.index))


def _check(status: int, what: str) -> None:
    global launches
    if status != 0:
        raise RuntimeError(f"batch_norm_act {what} launch failed: cudaError {status}")
    launches += 1


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


class _BatchNormAct(torch.autograd.Function):
    """The kernel's forward (statistics, running statistics, normalisation
    and epilogue) and backward (masked sums, then dx), one launch each."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, bn, mode):
        channels = x.shape[1]
        rows = x.numel() // channels
        y = torch.empty_like(x)
        p = _plan_for(x, y) if residual is None else _plan_for(x, y, residual)
        saved = torch.empty((2, channels), dtype=torch.float32, device=x.device)
        partial = torch.empty((p.row_blocks, 2, channels), dtype=torch.float64, device=x.device)
        with torch.cuda.device(x.device):
            status = _lib().batch_norm_act_forward(
                x.data_ptr(), None if residual is None else residual.data_ptr(), y.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), bn.running_mean.data_ptr(),
                bn.running_var.data_ptr(), bn.num_batches_tracked.data_ptr(),
                saved[0].data_ptr(), saved[1].data_ptr(), partial.data_ptr(),
                rows, channels, *p, mode, float(bn.eps), float(bn.momentum),
                torch.cuda.current_stream(x.device).cuda_stream)
        _check(status, "forward")
        ctx.mode = mode
        ctx.save_for_backward(x, weight, bias, saved, y if mode == 2 else None)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, saved, y = ctx.saved_tensors
        mode = ctx.mode
        dy = _channels_last(dy)
        channels = x.shape[1]
        rows = x.numel() // channels
        dx = torch.empty_like(x)
        dres = torch.empty_like(x) if mode == 2 else None
        p = _plan_for(*(t for t in (x, dy, dx, y, dres) if t is not None))
        grads = torch.empty((2, channels), dtype=torch.float32, device=x.device)
        partial = torch.empty((p.row_blocks, 2, channels), dtype=torch.float32, device=x.device)
        coef = torch.empty((3, channels), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            status = _lib().batch_norm_act_backward(
                dy.data_ptr(), x.data_ptr(), None if y is None else y.data_ptr(), dx.data_ptr(),
                None if dres is None else dres.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                saved[0].data_ptr(), saved[1].data_ptr(), grads[0].data_ptr(),
                grads[1].data_ptr(), partial.data_ptr(), coef.data_ptr(),
                rows, channels, *p, mode, torch.cuda.current_stream(x.device).cuda_stream)
        _check(status, "backward")
        return dx, grads[0], grads[1], dres, None, None


def batch_norm_act_cuda(x: torch.Tensor, bn, *, relu: bool,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' :func:`batch_norm_act` for a training forward of a CUDA
    bfloat16 ``x`` (``(N, C, H, W)``, made channels-last if it is not), with
    ``bn``'s float32 parameters and running statistics; raises on anything
    else."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4):
        raise TypeError(f"batch_norm_act_cuda: need a 4-D CUDA bfloat16 tensor, got "
                        f"{x.dim()}-D {x.dtype} on {x.device}")
    if not bn.training or bn.momentum is None or bn.weight is None or bn.running_mean is None:
        raise ValueError("batch_norm_act_cuda: need a training-mode affine layer with running "
                         "statistics and a momentum")
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
           for t in params):
        raise TypeError("batch_norm_act_cuda: parameters and running statistics must be "
                        "contiguous float32 on the input's device")
    channels = x.shape[1]
    rows = x.numel() // max(channels, 1)
    if rows <= 1:
        raise ValueError(f"Expected more than 1 value per channel when training, got input "
                         f"size {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError("batch_norm_act_cuda: the input must have fewer than 2^31 elements")
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype or residual.device != x.device:
            raise TypeError(f"batch_norm_act_cuda: the residual must match the input, got "
                            f"{tuple(residual.shape)} {residual.dtype} on {residual.device}")
        residual = _channels_last(residual)
    return _BatchNormAct.apply(_channels_last(x), bn.weight, bn.bias, residual, bn,
                               MODES[(relu, residual is not None)])


def batch_norm_act(x: torch.Tensor, bn, *, relu: bool,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(bn(x) + residual)``, ``relu(bn(x))`` or ``bn(x)``: the kernels
    where :func:`takes_kernel`, else :func:`batch_norm_act_plain`. A residual
    needs ``relu``."""
    if residual is not None and not relu:
        raise ValueError("batch_norm_act: a residual is added only before a ReLU")
    kernel = takes_kernel(x, bn)
    if profiling.enabled():
        profiling.count("bn_act.kernel" if kernel else "bn_act.plain")
    if kernel:
        return batch_norm_act_cuda(x, bn, relu=relu, residual=residual)
    return batch_norm_act_plain(x, bn, relu=relu, residual=residual)
