"""PyTorch port, the tracer of ``dahpe_tpu_torch.utils.profiling`` on the CPU.

- Off, ``span`` and ``phase`` return one shared null context and record or
  launch nothing.
- On, spans nest: each records its enclosing span's name and the call's
  ``call_id``; ``take_spans`` returns the finished ones and clears them.
- The spans' clock is the one ``torch.profiler``'s trace counts from: after
  the conversion by ``kineto_results.trace_start_ns()``, a span around a
  ``record_function`` block starts less than 1 ms before its event.
- A fused DA iteration (K = 1 and K = 2, shared target features on and off)
  records ``producer, step_a, step_b, step_c, ema`` in each iteration, inside
  ``fused.call``, and marks each phase and the end on a card's stream (the
  marker launch is recorded here in place of the kernel).
- ``split_phases`` splits a device event list by its markers exactly, and
  ``trace`` writes the spans as a track of ``trace.json`` and the phases and
  counters into ``summary.json``.

The markers themselves (``csrc/phase_marker.cu``) run on the card only:
``python3 portbench/trace_phases.py`` traces a training cell's loop with
them there.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dahpe_tpu_torch import models
from dahpe_tpu_torch.data.device_store import DeviceDataStore
from dahpe_tpu_torch.data.synthetic import SyntheticHands
from dahpe_tpu_torch.train import create_da_state, make_fused_da_iteration
from dahpe_tpu_torch.utils import profiling

IMAGE, HM, B = 64, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off and no spans kept."""
    profiling.enable(False)
    profiling.take_spans()
    yield
    profiling.enable(False)
    profiling.take_spans()


@pytest.fixture
def launched(monkeypatch):
    """The markers launched, ``(marker, device)``, in place of the kernel."""
    out = []
    monkeypatch.setattr(profiling, "_launch_marker", lambda name, dev: out.append((name, dev)))
    return out


def test_off_returns_the_shared_null_context_and_records_nothing(launched):
    a, b = profiling.span("x"), profiling.span("y", call=True)
    c = profiling.phase("step_a", torch.device("cuda"))
    assert a is b is c is profiling._NULL
    with a, c:
        profiling.mark_end(torch.device("cuda"))
    assert profiling.take_spans() == [] and launched == []


def test_spans_nest_with_parents_and_call_ids():
    profiling.enable(True)
    with profiling.span("outer", call=True):
        with profiling.span("inner"):
            pass
        with profiling.phase("step_a", "cpu"):
            with profiling.span("leaf"):
                pass
    with profiling.span("next", call=True):
        pass
    with profiling.span("loose"):
        pass
    spans = profiling.take_spans()
    assert [(s[0], s[3]) for s in spans] == [
        ("outer", None), ("inner", "outer"), ("step_a", "outer"), ("leaf", "step_a"),
        ("next", None), ("loose", None)]
    first, second = spans[0][4], spans[4][4]
    assert [s[4] for s in spans] == [first] * 4 + [second, None] and second == first + 1
    for name, start, end, _, _ in spans:
        assert start <= end, name
    assert spans[1][1] >= spans[0][1] and spans[1][2] <= spans[0][2]


def test_take_spans_clears_and_keeps_open_spans():
    profiling.enable(True)
    with profiling.span("open"):
        with profiling.span("done"):
            pass
        assert [s[0] for s in profiling.take_spans()] == ["done"]
        assert profiling.take_spans() == []
    assert [s[0] for s in profiling.take_spans()] == ["open"]
    assert profiling.take_spans() == []


def test_spans_share_the_profiler_clock():
    """Each span is stamped before its ``record_function`` event starts,
    and the closest pair starts less than 1 ms apart on the trace's line."""
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.span(f"s{i}"):
                with record_function(f"block{i}"):
                    torch.ones(64).sum()
    origin = prof.profiler.kineto_results.trace_start_ns()
    spans = {s[0]: s for s in profiling.take_spans()}
    events = {e.name: e for e in prof.events() if e.name.startswith("block")}
    leads = []
    for i in range(5):
        start_us = (spans[f"s{i}"][1] - origin) / 1e3
        end_us = (spans[f"s{i}"][2] - origin) / 1e3
        ev = events[f"block{i}"].time_range
        assert start_us <= ev.start and ev.end <= end_us, i
        leads.append(ev.start - start_us)
    assert min(leads) < 1000.0, leads


@pytest.fixture(scope="module")
def stores():
    mk = dict(n=8, seed=5, image_size=(IMAGE, IMAGE), heatmap_size=(HM, HM))
    return [DeviceDataStore(SyntheticHands(domain=d, split="train", **mk), device="cpu",
                            raw_size=96, verbose=False) for d in ("source", "target")]


def _fused(stores, k, share):
    torch.manual_seed(0)
    model = models.MultiHeadPoseResNet(models.ResNet(models.BasicBlock, [1, 1, 1, 1]),
                                       num_keypoints=21)
    state = create_da_state(model, device="cpu", with_ema=True)
    fused = make_fused_da_iteration(model, *stores, B, image_size=IMAGE, heatmap_size=HM,
                                    steps_per_call=k, ema_decay=0.99,
                                    share_target_features=share)
    return fused, state, [stores[0].generator(1), stores[1].generator(2)]


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("k", [1, 2])
def test_fused_da_iteration_records_its_phases(stores, k, share, launched):
    fused, state, gens = _fused(stores, k, share)
    profiling.enable(True)
    calls = 2 if k == 1 else 1
    for _ in range(calls):
        state, metrics, *_ = fused(state, *gens)
    assert state.step == 2 and all(torch.isfinite(metrics[n]) for n in ("loss_s", "loss_gt"))
    spans = profiling.take_spans()
    one = ["producer", "step_a", "step_b", "step_c", "ema"]
    phases = [s for s in spans if s[0] in profiling.PHASES]
    assert [s[0] for s in phases] == one * 2
    assert all(s[3] == "fused.call" for s in phases)
    call_spans = [s for s in spans if s[0] == "fused.call"]
    covers = [s for s in spans if s[0] == "fused.cover"]
    assert len(call_spans) == len(covers) == calls
    assert [s[4] for s in phases] == [c[4] for c in call_spans for _ in range(10 // calls)]
    assert sorted(s[1] for s in phases) == [s[1] for s in phases]  # flat, in order
    assert launched == []  # nothing marks a CPU stream


def test_phases_mark_a_card_stream_in_order(stores, launched, monkeypatch):
    """Where the state lies on a card, each phase marks its start and the
    step marks its end, in the order the iteration runs them (the fused call
    is driven on the CPU with the phases' device reported as a card)."""
    fused, state, gens = _fused(stores, 1, True)
    card = torch.device("cuda", 0)
    real_phase = profiling.phase
    monkeypatch.setattr(profiling, "phase", lambda name, device: real_phase(name, card))
    real_end = profiling.mark_end
    monkeypatch.setattr(profiling, "mark_end", lambda device: real_end(card))
    profiling.enable(True)
    fused(state, *gens)
    assert launched == [(m, card) for m in profiling.MARKERS]


def _marker(phase):
    return f"void dahpe_phase_marker<dahpe_phase::{phase}>()"


def test_split_phases_is_exact():
    events = [
        ("zero_sums", 0.0, 1.0),
        (_marker("producer"), 2.0, 2.5), ("rotate3_fused_kernel", 3.0, 7.0),
        (_marker("step_a"), 8.0, 8.5), ("conv", 9.0, 19.0), ("bn", 18.0, 21.0),
        (_marker("step_b"), 22.0, 22.5), ("gemm", 23.0, 28.0),
        (_marker("step_c"), 29.0, 29.5), ("dgrad", 30.0, 36.0),
        (_marker("ema"), 37.0, 37.5), ("multi_tensor_apply", 38.0, 40.0),
        (_marker("end"), 41.0, 41.5), ("add_sums", 42.0, 42.25),
        (_marker("producer"), 43.0, 43.5), ("render_gaussian_kernel", 44.0, 45.0),
        (_marker("end"), 46.0, 46.5), ("div", 47.0, 47.5),
    ]
    whole = events[:14] + events[15:16] + events[17:]  # the second iteration's markers out
    split = profiling.split_phases(list(reversed(whole)))  # bn overlaps conv
    assert split.phases == {"producer": 4.0, "step_a": 12.0, "step_b": 5.0, "step_c": 6.0,
                            "ema": 2.0}
    assert split.outside == 2.75 and split.broken == 0
    kernels = [e for e in whole if "dahpe_phase_marker" not in e[0]]
    assert split.kernels == kernels
    assert split.events["step_a"] == [("conv", 9.0, 19.0), ("bn", 18.0, 21.0)]
    assert [e[0] for e in split.events[None]] == ["zero_sums", "add_sums",
                                                  "render_gaussian_kernel", "div"]
    assert sum(map(len, split.events.values())) == len(kernels)
    # a lost marker or a cut iteration breaks the split: no phase time is given
    cut = profiling.split_phases(events)
    assert cut.phases is None and cut.broken == 1 and cut.outside == 1.75
    lost = profiling.split_phases(events[:8] + events[9:13])  # step_c's marker lost
    assert lost.phases is None and lost.broken == 1
    assert lost.events["step_b"] == [("gemm", 23.0, 28.0), ("dgrad", 30.0, 36.0)]
    assert profiling.split_phases(events[:12]).broken == 1  # no end marker
    assert profiling.marker_phase(_marker("step_b")) == "step_b"
    assert profiling.marker_phase("void foo<int>()") is None
    bare = profiling.split_phases([("k", 0.0, 3.0)])
    assert bare.phases == dict.fromkeys(profiling.PHASES, 0.0) and bare.broken == 0
    assert bare.outside == 3.0 and bare.kernels == [("k", 0.0, 3.0)]


def test_trace_writes_the_span_track_and_the_phases(stores, tmp_path):
    fused, state, gens = _fused(stores, 1, True)
    profiling.enable(True)
    with profiling.trace(str(tmp_path)) as summary:
        fused(state, *gens)
    assert summary["phase_ms"] == dict.fromkeys(profiling.PHASES, 0.0)  # no card, no markers
    assert summary["captures"] == summary["replays"] == 0 and summary["kernels"] == 0
    assert summary["broken_iterations"] == 0
    # every batch norm of the iteration on the plain path (no card), counted
    # since the tracer went on
    assert "bn_act.kernel" not in summary["since_on"] and summary["since_on"]["bn_act.plain"] > 0
    assert json.load(open(tmp_path / "summary.json")) == summary
    trace = json.load(open(tmp_path / "trace.json"))
    track = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in track if e["name"] in profiling.PHASES] == list(profiling.PHASES)
    # on the time line of the profiler's own events: inside the trace's span
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") != "program_span"]
    call = next(e for e in track if e["name"] == "fused.call")
    assert min(e["ts"] for e in ops) - 1e3 <= call["ts"] <= max(e["ts"] for e in ops)
    assert profiling.take_spans() == []
