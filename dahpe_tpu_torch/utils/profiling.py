"""Device traces, the program's spans and the DA iteration's phase markers.

Port of ``dahpe_tpu/utils/profiling.py``. :func:`trace` captures a
``torch.profiler`` trace (CPU ops and CUDA kernels) into ``logdir`` for the
CLI's ``--profile N`` and summarizes it: wall time, the device's busy time
(the union of kernel intervals), its idle share and the device time of each
phase of the DA iteration.

The tracer is off by default and turned on in code (:func:`enable`). Off,
:func:`span` and :func:`phase` return one shared null context after a
single flag read: nothing is recorded or launched. On:

- :func:`span` records ``(name, start_ns, end_ns, parent, call_id)`` in a
  bounded list that :func:`take_spans` reads and clears. ``parent`` is the
  name of the enclosing span of the same thread; ``call_id`` is shared by
  the spans of one call (one fused call of the DA loop), set by the span
  that opens it with ``call=True``. Times are :data:`clock_ns`, the wall
  clock ``torch.profiler``'s trace counts from
  (``kineto_results.trace_start_ns()``), so host spans and device events fall
  on one time line.
- :func:`phase` is a span that also launches a marker kernel
  (``csrc/phase_marker.cu``) on the device's current stream when it opens,
  and :func:`mark_end` closes the iteration's last phase. Markers captured
  in a CUDA graph run in every replay, so a device trace splits its kernels
  by phase (:func:`split_phases`) where host spans cannot: under replay the
  captured body's Python ran once, at capture. The marker library is built
  and loaded the first time tracing is turned on with a card present.

:func:`count` keeps counters (the fused loop's ``captures`` and
``replays``) whether tracing is on or not; :func:`counters` reads them.
Some callers count only while it is on (``ops.batch_norm_act``, under a CUDA
graph once, at capture); :func:`trace` reports every counter's change since
the tracer was last turned on.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import threading
import time
from typing import NamedTuple

import torch

# the markers' order in csrc/phase_marker.cu: the DA iteration's phases, in
# the order they run, then the iteration's end
MARKERS = ("producer", "step_a", "step_b", "step_c", "ema", "end")
PHASES = MARKERS[:-1]
MAX_SPANS = 1 << 20
LIB_NAME = "phase_marker"
SOURCES = ["phase_marker.cu"]
_MARKER_NAME = re.compile(r"dahpe_phase_marker<dahpe_phase::(\w+)>")

clock_ns = time.time_ns

_on = False
_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_spans: list[list] = []
_dropped = 0
_next_call = 0
_local = threading.local()
_counters: dict[str, int] = {}
_on_since: dict[str, int] = {}  # the counters when the tracer was last turned on
_NULL = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the tracer on or off. The first time it is turned on with a card
    present, the marker library is built and loaded."""
    global _on, _lib, _on_since
    if on and _lib is None and torch.cuda.is_available():
        from dahpe_tpu_torch.ops import _build

        lib = _build.load(LIB_NAME, SOURCES)
        lib.dahpe_phase_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.dahpe_phase_mark.restype = ctypes.c_int
        _lib = lib
    if on and not _on:
        _on_since = counters()
    _on = bool(on)


def enabled() -> bool:
    return _on


def _launch_marker(name: str, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = _lib.dahpe_phase_mark(MARKERS.index(name), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase marker launch failed: cudaError {err}")


class _Span:
    __slots__ = ("name", "call", "device", "rec")

    def __init__(self, name: str, call: bool, device):
        self.name, self.call, self.device = name, call, device

    def __enter__(self):
        global _dropped, _next_call
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        with _lock:
            if self.call:
                call_id, _next_call = _next_call, _next_call + 1
            else:
                call_id = parent[4] if parent else None
            rec = [self.name, clock_ns(), None, parent[0] if parent else None, call_id]
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped += 1
        stack.append(rec)
        self.rec = rec
        if self.device is not None and self.device.type == "cuda":
            _launch_marker(self.name, self.device)
        return self

    def __exit__(self, *exc):
        self.rec[2] = clock_ns()
        _local.stack.pop()
        return False


def span(name: str, *, call: bool = False):
    """A host span around the ``with`` block; ``call=True`` opens a new call
    (its spans and their children share a new ``call_id``)."""
    if not _on:
        return _NULL
    return _Span(name, call, None)


def phase(name: str, device):
    """A span of the DA iteration's phase ``name`` (one of :data:`PHASES`)
    whose opening also marks the phase's start on ``device``'s current
    stream (no marker on the CPU)."""
    if not _on:
        return _NULL
    return _Span(name, False, torch.device(device))


def mark_end(device) -> None:
    """Mark the end of the iteration's last phase on ``device``."""
    if _on and torch.device(device).type == "cuda":
        _launch_marker("end", torch.device(device))


def take_spans() -> list[tuple]:
    """The finished spans ``(name, start_ns, end_ns, parent, call_id)`` in
    the order they opened; clears them (open spans stay)."""
    global _spans
    with _lock:
        done = [tuple(r) for r in _spans if r[2] is not None]
        _spans = [r for r in _spans if r[2] is None]
    return done


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """The counters' values since the process started, with ``dropped_spans``:
    spans :data:`MAX_SPANS` left out."""
    return dict(_counters, dropped_spans=_dropped)


def marker_phase(name: str) -> str | None:
    """The marker (one of :data:`MARKERS`) a device event's name is, or None."""
    m = _MARKER_NAME.search(name)
    return m.group(1) if m else None


class PhaseSplit(NamedTuple):
    """A device trace split by its phase markers (:func:`split_phases`)."""

    phases: dict[str, float] | None  # each phase's device time; None if any iteration is broken
    outside: float  # device time of the kernels in no phase
    events: dict[str | None, list]  # each phase's kernels; None: those in no phase
    kernels: list  # every event but the markers, in time order
    broken: int  # iterations whose markers are not MARKERS in order


def split_phases(events) -> PhaseSplit:
    """Device ``events`` ``(name, start, end)`` split by the phase markers
    among them: a phase's kernels are those between its marker and the
    next, its time their union of intervals; kernels before a first marker
    or after an ``end`` are in no phase. An iteration is the markers up to
    an ``end``; one that is not :data:`MARKERS` in order (a marker lost, or
    an iteration cut off) is broken, and then no phase time is given, since
    a lost marker's kernels would count under the phase before it."""
    by_phase = {p: [] for p in (*PHASES, None)}
    current, kernels, seen, broken = None, [], [], 0
    for ev in sorted(events, key=lambda e: e[1]):
        marker = marker_phase(ev[0])
        if marker is None:
            kernels.append(ev)
            by_phase[current].append(ev)
            continue
        seen.append(marker)
        current = None if marker == "end" else marker
        if marker == "end":
            broken += tuple(seen) != MARKERS
            seen = []
    broken += bool(seen)
    phases = None if broken else {p: _busy(ev[1:] for ev in by_phase[p]) for p in PHASES}
    return PhaseSplit(phases, _busy(ev[1:] for ev in by_phase[None]), by_phase, kernels, broken)


def _busy(intervals) -> float:
    busy, last = 0.0, None
    for a, b in sorted(intervals):
        a = a if last is None else max(a, last)
        if b > a:
            busy += b - a
        last = b if last is None else max(last, b)
    return busy


def device_busy_us(events) -> tuple[float, int]:
    """The union of the CUDA kernel intervals among profiler ``events`` (µs)
    and the number of those intervals."""
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return _busy(spans), len(spans)


def _add_span_track(path: str, spans: list[tuple]) -> None:
    """Append the program's spans to the chrome trace at ``path`` as a track
    of their own, on the kernels' time line."""
    with open(path) as fh:
        data = json.load(fh)
    base = data.get("baseTimeNanoseconds", 0)  # the trace's "ts" count from it (µs)
    pid = os.getpid()
    track = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": "program spans",
              "args": {"name": "program spans"}}]
    track += [{"ph": "X", "cat": "program_span", "name": name, "pid": pid,
               "tid": "program spans", "ts": (a - base) / 1e3, "dur": (b - a) / 1e3,
               "args": {"parent": parent, "call_id": call_id}}
              for name, a, b, parent, call_id in spans]
    data.setdefault("traceEvents", []).extend(track)
    with open(path, "w") as fh:
        json.dump(data, fh)


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir): step(...)`` records a ``torch.profiler`` trace of
    the block (CUDA activity when a card is present), writes it to
    ``dir/trace.json`` (chrome://tracing, Perfetto) with the program's spans
    of the block as a track, and ``dir/summary.json``: ``wall_ms``,
    ``device_busy_ms``, ``idle_share`` and ``kernels`` (phase markers left
    out), the device ms of each phase (``phase_ms``, zero without markers,
    None if ``broken_iterations``, the iterations whose markers are not all
    there in order, is not 0) and of kernels in none (``outside_ms``), the
    block's ``captures`` and ``replays``, and ``since_on``: each counter
    that moved since the tracer was last turned on, by how much (a graph
    replayed in the block counted its calls at its capture, before the
    block). The block should end synchronized with the device (e.g.
    by fetching a result), so its wall time covers the device work it
    queued."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    summary = {}
    take_spans()
    before = counters()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield summary
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = take_spans()
    after = counters()
    device = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    split = split_phases(device)
    busy_us = _busy([(a, b) for _, a, b in split.kernels])
    summary.update(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                   idle_share=(1.0 - busy_us / wall_us) if split.kernels else None,
                   kernels=len(split.kernels),
                   phase_ms=split.phases and {p: v / 1e3 for p, v in split.phases.items()},
                   outside_ms=split.outside / 1e3, broken_iterations=split.broken,
                   **{n: after.get(n, 0) - before.get(n, 0) for n in ("captures", "replays")},
                   since_on={n: v - _on_since.get(n, 0) for n, v in after.items()
                             if v != _on_since.get(n, 0)})
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_span_track(path, spans)
    with open(os.path.join(logdir, "summary.json"), "w") as fh:
        json.dump(summary, fh)
