"""Whole-iteration fusion: batch production + train step in one call.

Port of ``dahpe_tpu/train/fused.py`` for one device. With a
:class:`~dahpe_tpu_torch.data.device_store.DeviceDataStore` a DA iteration
is: sample gather + augmentation + Gaussian targets for BOTH domains, then
the three-step minimax step, with the sampling generators advancing on the
card. Nothing crosses to the host between iterations.

``steps_per_call > 1`` (K iterations per call, a ``lax.scan`` in the JAX
package) is to become a replay of K captured iterations as a CUDA graph;
that is ROADMAP.md queue 1 item 7 and is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from dahpe_tpu_torch.train.da import make_da_train_step
from dahpe_tpu_torch.train.pretrain import make_pretrain_step


def _one_step_per_call(steps_per_call: int) -> None:
    if steps_per_call != 1:
        raise NotImplementedError(
            f"steps_per_call={steps_per_call}: K > 1 is to be a CUDA-graph replay of K "
            "captured iterations, not ported yet (ROADMAP.md queue 1 item 7)"
        )


def make_fused_da_iteration(model, source_store, target_store, batch_size: int, *,
                            image_size: int = 256, heatmap_size: int = 64,
                            rotation: float = 180.0, scale_range=(0.6, 1.3),
                            sigma: float = 2.0, steps_per_call: int = 1,
                            **step_config) -> Callable:
    """``(state, s_gen, t_gen) -> (state, metrics, s_gen, t_gen)``: one DA
    iteration drawing its source and target batches from the stores with
    the two generators (on the stores' device), which advance in place.
    ``step_config`` goes to :func:`~dahpe_tpu_torch.train.da.make_da_train_step`."""
    _one_step_per_call(steps_per_call)
    cfg = dict(image_size=image_size, heatmap_size=heatmap_size, rotation=rotation,
               scale_range=tuple(scale_range), sigma=sigma)
    src = source_store.traced_batch_fn(batch_size, **cfg)
    tgt = target_store.traced_batch_fn(batch_size, **cfg)
    step = make_da_train_step(model, **step_config)

    def call(state, s_gen: torch.Generator, t_gen: torch.Generator):
        state, metrics = step(state, src(s_gen), tgt(t_gen))
        return state, metrics, s_gen, t_gen

    return call


def make_fused_pretrain_iteration(model, source_store, batch_size: int, *,
                                  image_size: int = 256, heatmap_size: int = 64,
                                  rotation: float = 180.0, scale_range=(0.6, 1.3),
                                  sigma: float = 2.0, steps_per_call: int = 1,
                                  **step_config) -> Callable:
    """``(state, gen, lr) -> (state, metrics, gen)``: the supervised pretrain
    counterpart of :func:`make_fused_da_iteration`."""
    _one_step_per_call(steps_per_call)
    src = source_store.traced_batch_fn(
        batch_size, image_size=image_size, heatmap_size=heatmap_size, rotation=rotation,
        scale_range=tuple(scale_range), sigma=sigma,
    )
    step = make_pretrain_step(model, **step_config)

    def call(state, gen: torch.Generator, lr: float):
        state, metrics = step(state, src(gen), lr)
        return state, metrics, gen

    return call
