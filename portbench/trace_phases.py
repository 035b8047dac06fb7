"""A training cell's DA loop traced with the program's own tracer on
(``dahpe_tpu_torch.utils.profiling``: host spans and the phase markers).

    python3 portbench/trace_phases.py --workload train_bf16_k4 --seed <n> \\
        [--seconds 10] [--pairs 3] [--out phases.json]

Set-up is the cell's own (``drivers.da_train.prepare`` and the traffic's
warm-up). Then, on the same fused iteration, state and generators:

1. ``--pairs`` pairs of windows of ``--seconds`` (``drivers.da_train.window``),
   the tracer off and on in turns (off, on, on, off, ...), each after one
   call that captures the graph again where the tracer was toggled: the
   window's img/s with the tracer on against off is its cost.
2. Four slices of ``trace_calls`` calls profiled, the tracer off, on, on,
   off, each taken as ``drivers.da_train.profile_slice`` takes its own, with
   the capture before it. The kernels are split by the phase markers
   (``profiling.split_phases``; no phase times where an iteration's markers
   are not all there) and by kind (the yardstick's kinds); the
   marker kernels are taken out before the yardstick's reduction, whose idle
   gaps are then named by the innermost of the ``call``/``read`` stamps and the
   program's spans. The existing device-trace readers read each reduction as
   they read the harness's, so the slices with the tracer off are their
   baseline in the same process.
3. The checks of the clocks: each phase marker against the start of its
   host span (eager calls), or each replay's first marker against its
   ``fused.replay`` span (replayed calls).

The result is one JSON object (``--out``, and a summary on standard error).
It stands in for the phase split in ``drivers.da_train.profile_slice``:
once that slice splits the phases itself, this script is deleted.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]

import torch  # noqa: E402

from portbench import harness, yardstick  # noqa: E402
from portbench.drivers import da_train  # noqa: E402

# the existing device-trace readers of a training cell
READERS = ("idle_share.train", "bn_ms_per_iter.train", "pseudo_labels_roofline",
           "rotate3_fused_roofline")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def toggle(fused, state, gens, on: bool, device) -> None:
    """Turn the tracer on or off, then one call (a replayed cell captures
    its graph again there) and a synchronise."""
    from dahpe_tpu_torch.utils import profiling

    profiling.enable(on)
    state, metrics, _, _ = fused(state, *gens)
    da_train.host_losses(metrics)
    da_train.sync(device)


def windows(fused, state, gens, traffic, seconds, pairs, device) -> list[dict]:
    """``pairs`` pairs of windows, the tracer off and on in turns."""
    order = [on for p in range(pairs) for on in ((False, True) if p % 2 == 0 else (True, False))]
    out = []
    for on in order:
        toggle(fused, state, gens, on, device)
        win = da_train.window(fused, state, gens, traffic, seconds, device, trace=False)
        out.append({"tracer": on, "img_s": win["frames"] / win["seconds"],
                    "seconds": win["seconds"], "iters": win["iters"],
                    "chunk_img_s": win["chunk_img_s"]})
        log(f"window (tracer {'on' if on else 'off'}): {out[-1]['img_s']:.3f} img/s")
    return out


def traced_slice(fused, state, gens, traffic, device, on: bool) -> dict:
    """``trace_calls`` calls under ``torch.profiler`` with the tracer ``on``
    or off, taken as ``drivers.da_train.profile_slice`` takes its slice."""
    from torch.profiler import ProfilerActivity, profile

    from dahpe_tpu_torch.utils import profiling

    on_card = torch.device(device).type == "cuda"
    n, k = int(traffic["trace_calls"]), int(traffic["steps_per_call"])
    toggle(fused, state, gens, on, device)
    stamps = []
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        state, metrics, _, _ = fused(state, *gens)
        da_train.host_losses(metrics)
        da_train.sync(device)
        before = profiling.counters()
        profiling.take_spans()
        for _ in range(n):
            a = time.time_ns()
            state, metrics, _, _ = fused(state, *gens)
            stamps.append(("call", a, time.time_ns()))
        a = time.time_ns()
        vals = da_train.host_losses(metrics)
        da_train.sync(device)
        stamps.append(("read", a, time.time_ns()))
    after = profiling.counters()
    program = profiling.take_spans()
    profiling.enable(False)
    origin = prof.profiler.kineto_results.trace_start_ns()

    def line(spans):  # (name, start_us, end_us) on the trace's time line
        return [(s[0], (s[1] - origin) / 1e3, (s[2] - origin) / 1e3) for s in spans]

    host = line(stamps)
    ours = line(program)
    begin, finish = host[0][1], host[-1][2]
    device_events = [(e.name, max(e.time_range.start, begin), min(e.time_range.end, finish))
                     for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.time_range.end > begin and e.time_range.start < finish]
    split = profiling.split_phases(device_events)
    markers = [(profiling.marker_phase(name), a) for name, a, _ in sorted(
        device_events, key=lambda e: e[1]) if profiling.marker_phase(name)]
    reduced = yardstick.reduce_trace(split.kernels, host + ours, begin, finish)
    reduced.update(wall_s=(finish - begin) / 1e6, calls=n, iters=n * k, losses=vals,
                   launches={name: sum(1 for ev in split.kernels if name in ev[0])
                             for name in yardstick.PORT_KERNELS})
    by_kind = {}
    for phase, events in split.events.items():
        row = by_kind.setdefault(phase or "outside", {})
        for name, a, b in events:
            row[yardstick.kind_of(name)] = row.get(yardstick.kind_of(name), 0.0) + (b - a) / 1e6
    phases = split.phases and {p: v / 1e6 for p, v in split.phases.items()}
    return {"reduced": reduced, "phases_s": phases, "broken": split.broken,
            "outside_s": split.outside / 1e6, "by_kind_s": by_kind, "markers": markers,
            "program_spans": ours, "counters": {c: after.get(c, 0) - before.get(c, 0)
                                                for c in ("captures", "replays")},
            "k": k}


def clock_checks(sl: dict) -> dict:
    """Markers against host spans on the trace's time line (µs): in eager
    calls each phase's marker against its span's start (a negative lead is a
    marker before its span); in replayed calls each replay's first marker
    against its ``fused.replay`` span's start."""
    from dahpe_tpu_torch.utils import profiling

    spans = sl["program_spans"]
    if sl["k"] == 1:
        host = [(name, a) for name, a, _ in spans if name in profiling.PHASES]
        dev = [(m, a) for m, a in sl["markers"] if m != "end"]
    else:
        host = [("producer", a) for name, a, _ in spans if name == "fused.replay"]
        dev = [(m, a) for m, a in sl["markers"] if m == "producer"]
    paired = [(h, d) for h, d in zip(host, dev)]
    leads = [d[1] - h[1] for h, d in paired]
    return {"pairs": len(paired), "host": len(host), "device": len(dev),
            "names_match": all(h[0] == d[0] for h, d in paired),
            "violations_over_20us": sum(1 for v in leads if v < -20.0),
            "min_lead_us": min(leads) if leads else None,
            "median_lead_us": statistics.median(leads) if leads else None}


def readings(config, traffic, sl: dict) -> dict:
    """The eight phase readings (device ms an iteration) and the existing
    device-trace readers on the slice without markers."""
    tr = sl["reduced"]
    iters, phases = tr["iters"], sl["phases_s"]
    out = {f"{p}_ms_per_iter": 1e3 * phases[p] / iters if phases else None
           for p in ("producer", "step_a", "step_b", "step_c", "ema")}
    out["broken_iterations"] = sl["broken"]
    out["outside_ms_per_iter"] = 1e3 * sl["outside_s"] / iters
    out["busy_ms_per_iter"] = 1e3 * tr["busy_s"] / iters
    total = sum(phases.values()) + sl["outside_s"] if phases else None
    out["phases_over_busy"] = total / tr["busy_s"] if total and tr["busy_s"] else None
    out["outside_share_of_busy"] = sl["outside_s"] / tr["busy_s"] if tr["busy_s"] else None
    ctx = {"config": config, "traffic": traffic, "trace": tr, "window": None}
    for name in READERS:
        out[name] = harness.reader(name).read(ctx)
    return out


def trace_cell(config, traffic, seed, device, seconds, pairs) -> dict:
    fused, state, gens, _ = da_train.prepare(config, traffic, seed, device, lambda name: None)
    k = int(traffic["steps_per_call"])
    for _ in range(int(traffic["warmup_iters"]) // k):
        state, metrics, _, _ = fused(state, *gens)
    da_train.host_losses(metrics)
    wins = windows(fused, state, gens, traffic, seconds, pairs, device)
    slices = [traced_slice(fused, state, gens, traffic, device, on)
              for on in (False, True, True, False)]
    on = [w["img_s"] for w in wins if w["tracer"]]
    off = [w["img_s"] for w in wins if not w["tracer"]]
    cost = 1.0 - statistics.median(on) / statistics.median(off) if on and off else None
    sl = slices[1]
    tr = sl["reduced"]
    result = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
              "smi": da_train.smi(), "windows": wins, "tracer_cost": cost,
              "readings": readings(config, traffic, sl), "clock": clock_checks(sl),
              "slices": [{"tracer": on, "readings": readings(config, traffic, x),
                          "clock": clock_checks(x), "counters": x["counters"],
                          "gaps": x["reduced"]["gaps"][:10]}
                         for on, x in zip((False, True, True, False), slices)],
              "counters": sl["counters"], "calls": tr["calls"], "iters": tr["iters"],
              "busy_s": tr["busy_s"], "wall_s": tr["wall_s"],
              "phases_s": sl["phases_s"], "outside_s": sl["outside_s"],
              "by_kind_s": sl["by_kind_s"], "kinds_s": tr["kinds_s"],
              "gaps": tr["gaps"][:10],
              "losses_finite": all(math.isfinite(v) for x in slices
                                   for v in x["reduced"]["losses"])}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="trace a training cell with the program's tracer on")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: the phase markers run on the card only")
        return 2
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    config, traffic = harness.config_of(bench, cell), harness.traffic_of(cell["traffic"])
    result = trace_cell(config, traffic, args.seed, "cuda", args.seconds, args.pairs)
    result.update(workload=args.workload, seed=args.seed)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    log(json.dumps({k: result[k] for k in ("device", "tracer_cost", "readings", "clock",
                                           "counters", "calls", "iters")}))
    for x in result["slices"]:
        log("slice: " + json.dumps({"tracer": x["tracer"], "counters": x["counters"],
                                    **{n: x["readings"][n] for n in READERS}}))
    log("gaps: " + json.dumps(result["gaps"]))
    log("by phase and kind (s): " + json.dumps(result["by_kind_s"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
