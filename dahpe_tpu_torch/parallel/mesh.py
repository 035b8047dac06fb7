"""Data parallelism over the ranks of a process group.

Port of ``dahpe_tpu/parallel/mesh.py``. The JAX package runs the train step
as one SPMD program over a device mesh: the batch sharded, the state
replicated, and every mean over the batch axis a mean over the global batch
(GSPMD inserts the collectives). Here one process drives one device, holds
its rows of the global batch and a full copy of the state, and the step
issues the collectives itself (:class:`Collectives`):

- batch norm takes global statistics (``models.batch_norm``, cross-rank
  mode, switched on by the factories below);
- each SGD step's partitions have their gradients summed over the ranks in
  one flat buffer and divided by the world size: with equal local batches
  the mean of the local means is the global mean;
- the confidence gate's quantile and the reported accuracies are taken over
  the gathered rows of every rank, the losses averaged.

Parameters, momentum and EMA then stay equal on every rank; :func:`replicate`
broadcasts them from rank 0 once, at setup.

DDP does not fit the DA step: it assumes one backward pass per forward over
one parameter set, and the step runs three (all partitions, the adversarial
heads, the features through a detached leaf), each before its own SGD step.
``nn.SyncBatchNorm`` refuses CPU tensors once a group is up, so it cannot
run on gloo.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from dahpe_tpu_torch.models.batch_norm import set_process_group
from dahpe_tpu_torch.parallel.distributed import (
    collective_device,
    rank,
    this_device,
    world_size,
)


class Collectives:
    """The collectives of one data-parallel train step over ``group``
    (default: every rank). Each is issued at every world size, so a world
    of one runs them too (and gives back its inputs)."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self._flat: dict[tuple, torch.Tensor] = {}

    def grads(self, names: tuple[str, ...], grads: list[torch.Tensor]) -> None:
        """Average ``grads`` (the partitions ``names``) over the ranks in
        place: one SUM all-reduce of a flat buffer kept per partition set
        (allocated at its first use, so a captured graph reads and writes
        the same memory on every replay), divided by the world size."""
        flat = self._flat.get(names)
        if flat is None:
            flat = torch.empty(sum(g.numel() for g in grads), dtype=grads[0].dtype,
                               device=grads[0].device)
            self._flat[names] = flat
        views = [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]
        torch._foreach_copy_(views, grads)
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        torch._foreach_copy_(grads, views)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's ``rows`` (equal shapes), concatenated in rank order
        along the first axis: this rank's part of the global batch, made
        whole."""
        rows = rows.contiguous()
        parts = [torch.empty_like(rows) for _ in range(self.world)]
        dist.all_gather(parts, rows, group=self.group)
        return torch.cat(parts)

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of ``value`` over the ranks (a new tensor)."""
        out = value.clone()
        dist.all_reduce(out, group=self.group)
        return out.div_(self.world)


def create_mesh(devices: Sequence | None = None) -> list[torch.device]:
    """The devices of the data-parallel job: ``devices`` as given; else,
    with a process group up, each rank's device in rank order; else every
    local card (the CPU where there is none)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if dist.is_initialized():
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, str(this_device()))
        return [torch.device(d) for d in out]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def shard_batch(batch, group=None):
    """This rank's rows of a global ``batch`` (a tensor, an array or a dict
    of them): rows ``[r·B/W, (r+1)·B/W)``. ``B`` must divide by ``W``."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    r, w = rank(group), world_size(group)
    b = batch.shape[0]
    if b % w:
        raise ValueError(f"a global batch of {b} rows does not split over {w} ranks")
    return batch[r * (b // w):(r + 1) * (b // w)]


def _state_tensors(obj) -> list[torch.Tensor]:
    """The tensors a replica holds: a module's parameters and buffers; a
    train state's model, momentum (made where missing: zeros are what an
    unstepped partition's first step starts from) and EMA; a dict or list of
    tensors as they are."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict(keep_vars=True).values())
    if isinstance(obj, dict):
        return list(obj.values())
    if isinstance(obj, (list, tuple)):
        return list(obj)
    out = _state_tensors(obj.model)
    for opt in obj.optimizers.values():
        for group in opt.param_groups:
            for p in group["params"]:
                buf = opt.state[p].get("momentum_buffer")
                if buf is None:
                    buf = opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
                out.append(buf)
    return out + list((getattr(obj, "ema", None) or {}).values())


def _flat_bytes(tensors: list[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8).to(device)
                      for t in tensors])


def replicate(obj, group=None, *, src: int = 0):
    """Give every rank ``src``'s copy of ``obj`` (see :func:`_state_tensors`;
    a train state's step too) in place, in one broadcast of their bytes.
    Returns ``obj``; nothing happens without a group."""
    if not dist.is_initialized():
        return obj
    tensors = _state_tensors(obj)
    flat = _flat_bytes(tensors, collective_device(group))
    dist.broadcast(flat, src=src, group=group)
    with torch.no_grad():
        offset = 0
        for t in tensors:
            n = t.numel() * t.element_size()
            # a fresh copy: a dtype view needs an aligned storage offset
            t.copy_(flat[offset:offset + n].clone().view(t.dtype).view(t.shape))
            offset += n
    if hasattr(obj, "step") and hasattr(obj, "optimizers"):
        step = [obj.step]
        dist.broadcast_object_list(step, src=src, group=group)
        obj.step = step[0]
    return obj


def assert_replicated(obj, group=None, *, src: int = 0) -> int:
    """Raise unless every rank holds ``src``'s bytes of ``obj``'s tensors
    (see :func:`_state_tensors`); returns how many tensors were compared."""
    tensors = _state_tensors(obj)
    if not dist.is_initialized():
        return len(tensors)
    mine = _flat_bytes(tensors, collective_device(group))
    theirs = mine.clone()
    dist.broadcast(theirs, src=src, group=group)
    if not torch.equal(mine, theirs):
        raise AssertionError(f"rank {rank(group)}: the replicated tensors differ from "
                             f"rank {src}'s")
    return len(tensors)


def data_parallel(model, group=None) -> dict:
    """Make ``model`` one rank's replica in a data-parallel job over
    ``group``: its batch norm switched to global statistics. Returns the
    settings (``collectives=``) that make a train step, or a fused
    iteration, average the gradients over the ranks and report global
    metrics. Without a process group nothing changes and this is ``{}``.
    The one switch every data-parallel step goes through."""
    if not dist.is_initialized():
        return {}
    set_process_group(model, group)
    return {"collectives": Collectives(group)}


def make_parallel_da_step(model, group=None, **config):
    """The DA train step (``train.da.make_da_train_step``, ``config`` its
    settings) as one rank of a data-parallel job over ``group``
    (:func:`data_parallel`). Each rank passes its rows of the global batch;
    state in and out is equal on every rank, the metrics are global."""
    from dahpe_tpu_torch.train.da import make_da_train_step

    return make_da_train_step(model, **data_parallel(model, group), **config)


def make_parallel_pretrain_step(model, group=None, **config):
    """The pretrain step (``train.pretrain.make_pretrain_step``) as one rank
    of a data-parallel job; the contract of :func:`make_parallel_da_step`."""
    from dahpe_tpu_torch.train.pretrain import make_pretrain_step

    return make_pretrain_step(model, **data_parallel(model, group), **config)


def make_parallel_eval_step(model, group=None, *, device=None):
    """``eval_fn(images) -> heatmaps``: the eval forward (main head only)
    of this rank's rows of the global ``images``, all-gathered into the
    global batch's heatmaps on every rank, as the JAX package's sharded
    output."""
    from dahpe_tpu_torch.evaluate import _eval_forward, _place

    device = _place(model, device)
    collectives = Collectives(group) if dist.is_initialized() else None

    @torch.inference_mode()
    def eval_fn(images):
        y = _eval_forward(model, shard_batch(torch.as_tensor(images, device=device), group))
        return y if collectives is None else collectives.gather(y)

    return eval_fn


__all__ = [
    "Collectives",
    "assert_replicated",
    "create_mesh",
    "data_parallel",
    "make_parallel_da_step",
    "make_parallel_eval_step",
    "make_parallel_pretrain_step",
    "replicate",
    "shard_batch",
]
