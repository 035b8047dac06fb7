"""Whole-iteration fusion: batch production + train step in one call.

Port of ``dahpe_tpu/train/fused.py`` for one device. With a
:class:`~dahpe_tpu_torch.data.device_store.DeviceDataStore` a DA iteration
is: sample gather + augmentation + Gaussian targets for BOTH domains, then
the three-step minimax step, with the sampling generators advancing on the
card. Nothing crosses to the host between iterations.

``steps_per_call = K`` runs K consecutive iterations per call and returns
each metric's mean over the chunk (the JAX package's ``lax.scan``). On a
CUDA device the first call of a wrapper runs its K iterations eagerly, as K
single calls would: cuDNN, cuBLAS and the kernels' libraries load and pick
their algorithms there. It then captures one iteration on a side stream as
a CUDA graph, with the sampling generators registered with it, and every
later call replays the graph K times: each replay draws what one eager
call would draw, and the step count, learning rate and GL coefficient are
device tensors the iteration advances itself. On the CPU a call is a loop
of K steps. A capture or replay that fails raises; there is no eager
fallback. K = 1 is one eager step per call.

Under data parallelism (``collectives=`` in ``step_config``, sharded
stores) each rank runs its rows of the global batch and the captured
iteration holds the gradient, batch-norm and metric collectives. NCCL's
collectives are captured; gloo's cannot be, so a chunk above 1 on a card
under gloo with more than one rank is refused before anything is built.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from dahpe_tpu_torch.train.da import make_da_train_step
from dahpe_tpu_torch.train.pretrain import lr_tensor, make_pretrain_step


def _chunk_size(steps_per_call: int, device, collectives=None) -> int:
    k = int(steps_per_call)
    if k < 1:
        raise ValueError(f"steps_per_call={k}: K must be at least 1")
    if (k > 1 and torch.device(device).type == "cuda" and collectives is not None
            and collectives.world > 1 and dist.get_backend(collectives.group) == "gloo"):
        raise ValueError(f"steps_per_call={k}: gloo's collectives cannot be captured in a "
                         "CUDA graph; run K = 1 under gloo, or use NCCL")
    return k


class _Chunk:
    """``K`` runs of an iteration ``body() -> metrics`` (the state updated in
    place on ``device``) per call, returning the metrics' chunk means.

    On the card the first call runs eagerly on a side stream (the warm-up);
    the second captures ``body`` once on that stream into a private memory
    pool. From then on a call zeroes static sums, replays the graph ``K``
    times (each replay adds its metrics into the sums inside the graph) and
    divides the sums into fresh tensors, so what the caller keeps never lies
    in the pool a later replay rewrites.
    ``key`` names the objects the graph was captured on (the state, the
    generators): a call with others raises, since the graph would go on
    updating the captured ones."""

    def __init__(self, k: int, device: torch.device):
        self.k, self.device = k, torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.pool = None
        self.sums: dict[str, torch.Tensor] = {}
        self.key: tuple | None = None
        self.stream: torch.cuda.Stream | None = None  # the warm-up's and the captures'

    def eager(self, body: Callable[[], dict]) -> dict:
        """``K`` eager iterations; the metrics summed in the order a replayed
        chunk sums them, then divided."""
        total = None
        for _ in range(self.k):
            m = body()
            total = m if total is None else {name: total[name] + m[name] for name in total}
        return {name: v / self.k for name, v in total.items()}

    def capture(self, body: Callable[[], dict], generators) -> None:
        """Record one iteration (and the metrics' accumulation) as a graph."""
        if self.graph is not None:
            self.graph.reset()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # thread_local: a checkpoint draining on the saver's thread may copy
        # to the host while this thread captures
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            m = body()
            names = list(self.sums)
            torch._foreach_add_([self.sums[n] for n in names], [m[n] for n in names])
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.graph = graph

    def __call__(self, body: Callable[[], dict], key: tuple, generators, stale: bool) -> dict:
        """One call: ``stale`` says a table the iteration reads has moved,
        so the graph must be captured again."""
        if self.device.type != "cuda":
            return self.eager(body)
        with torch.cuda.device(self.device):
            if self.stream is None:  # the warm-up, on the stream captures use
                current = torch.cuda.current_stream(self.device)
                self.stream = torch.cuda.Stream(self.device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    means = self.eager(body)
                    self.sums = {n: torch.zeros_like(v) for n, v in means.items()}
                current.wait_stream(self.stream)
                for v in means.values():
                    v.record_stream(current)
                self.key = key
                return means
            if len(key) != len(self.key) or any(a is not b for a, b in zip(key, self.key)):
                raise ValueError("a captured iteration runs on the state and generators it "
                                 "was first called with; make a new iteration for others")
            if self.graph is None or stale:
                self.capture(body, generators)
            sums = list(self.sums.values())
            torch._foreach_zero_(sums)
            for _ in range(self.k):
                self.graph.replay()
            return dict(zip(self.sums, torch._foreach_div(sums, float(self.k))))


def make_fused_da_iteration(model, source_store, target_store, batch_size: int, *,
                            image_size: int = 256, heatmap_size: int = 64,
                            rotation: float = 180.0, scale_range=(0.6, 1.3),
                            sigma: float = 2.0, steps_per_call: int = 1,
                            **step_config) -> Callable:
    """``(state, s_gen, t_gen) -> (state, metrics, b_s, b_t)``:
    ``steps_per_call`` DA iterations drawing their source and target batches
    from the stores with the two generators (on the stores' device), which
    advance in place. At K = 1, ``b_s`` and ``b_t`` are the batches the
    iteration drew (the CLI's ``--debug`` draws them); with K > 1 the
    metrics are the chunk means and the batches ``None``.
    ``step_config`` goes to :func:`~dahpe_tpu_torch.train.da.make_da_train_step`."""
    k = _chunk_size(steps_per_call, source_store.device, step_config.get("collectives"))
    cfg = dict(image_size=image_size, heatmap_size=heatmap_size, rotation=rotation,
               scale_range=tuple(scale_range), sigma=sigma)
    src = source_store.traced_batch_fn(batch_size, **cfg)
    tgt = target_store.traced_batch_fn(batch_size, **cfg)
    step = make_da_train_step(model, **step_config)
    chunk = _Chunk(k, source_store.device)

    def call(state, s_gen: torch.Generator, t_gen: torch.Generator):
        if k == 1:
            b_s, b_t = src(s_gen), tgt(t_gen)
            state, metrics = step(state, b_s, b_t)
            return state, metrics, b_s, b_t
        stale = step.cover(state, k)
        metrics = chunk(lambda: step.run(state, src(s_gen), tgt(t_gen)),
                        (state, s_gen, t_gen), (s_gen, t_gen), stale)
        state.advance(k)
        return state, metrics, None, None

    return call


def make_fused_pretrain_iteration(model, source_store, batch_size: int, *,
                                  image_size: int = 256, heatmap_size: int = 64,
                                  rotation: float = 180.0, scale_range=(0.6, 1.3),
                                  sigma: float = 2.0, steps_per_call: int = 1,
                                  **step_config) -> Callable:
    """``(state, gen, lr) -> (state, metrics, gen)``: the supervised pretrain
    counterpart of :func:`make_fused_da_iteration`; ``lr`` (a host number or
    a 0-d tensor) is constant over a call's chunk, as the CLI's per-epoch
    schedule is."""
    k = _chunk_size(steps_per_call, source_store.device, step_config.get("collectives"))
    src = source_store.traced_batch_fn(
        batch_size, image_size=image_size, heatmap_size=heatmap_size, rotation=rotation,
        scale_range=tuple(scale_range), sigma=sigma,
    )
    step = make_pretrain_step(model, **step_config)
    chunk = _Chunk(k, source_store.device)
    lr_buf = torch.zeros((), dtype=torch.float32, device=source_store.device)

    def call(state, gen: torch.Generator, lr):
        if k == 1:
            state, metrics = step(state, src(gen), lr)
            return state, metrics, gen
        if isinstance(lr, torch.Tensor):
            lr_buf.copy_(lr_tensor(lr, lr_buf.device))
        else:
            lr_buf.fill_(float(np.float32(lr)))
        metrics = chunk(lambda: step.run(state, src(gen), lr_buf), (state, gen), (gen,), False)
        state.step += k
        return state, metrics, gen

    return call
