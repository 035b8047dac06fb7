"""Device traces and step timing.

Port of ``dahpe_tpu/utils/profiling.py``: :func:`trace` captures a
``torch.profiler`` trace (CPU ops and CUDA kernels) into ``logdir`` for the
CLI's ``--profile N`` and summarizes it: wall time, the device's busy time
(the union of kernel intervals) and its idle share. :class:`Throughput`
and :func:`annotate` as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


def device_busy_us(events) -> tuple[float, int]:
    """The union of the CUDA kernel intervals among profiler ``events`` (µs)
    and the number of those intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, last = 0.0, None
    for a, b in spans:
        a = a if last is None else max(a, last)
        if b > a:
            busy += b - a
        last = b if last is None else max(last, b)
    return busy, len(spans)


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir): step(...)`` records a ``torch.profiler`` trace of
    the block (CUDA activity when a card is present), writes it to
    ``dir/trace.json`` (chrome://tracing, Perfetto) and ``dir/summary.json``:
    ``wall_ms``, ``device_busy_ms``, ``idle_share`` and ``kernels``. The
    block should end synchronized with the device (e.g. by fetching a
    result), so its wall time covers the device work it queued."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    summary = {}
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield summary
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, kernels = device_busy_us(prof.events())
    summary.update(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                   idle_share=(1.0 - busy_us / wall_us) if kernels else None,
                   kernels=kernels)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "summary.json"), "w") as fh:
        json.dump(summary, fh)


class Throughput:
    """items/sec tracker with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.n_steps = 0
        self.n_items = 0
        self._t0 = None

    def step(self, n_items: int):
        self.n_steps += 1
        if self.n_steps == self.warmup:
            self._t0 = time.perf_counter()
            self.n_items = 0
        elif self.n_steps > self.warmup:
            self.n_items += n_items

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self.n_items == 0:
            return 0.0
        return self.n_items / (time.perf_counter() - self._t0)


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)
