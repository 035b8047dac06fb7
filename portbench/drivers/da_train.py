"""Driver of the DA training cells: the port's fused DA iteration, set up and
dispatched as ``python -m dahpe_tpu_torch.cli.train --device-store
--with-ema [--bf16] --steps-per-call K`` runs its DA loop.

Set-up builds one fused iteration (``train.fused.make_fused_da_iteration``)
over the seeded weights and two seeded device stores, drives it through the
compared calls (recording the losses, the momentum after the first call and
every tracked entry's change after the last), then warms it up with more
calls of the same traffic. The window calls it back to back, as the CLI
does: the calls queue ahead on the stream and the losses come to the host
only every ``print_freq`` iterations and at the window's end, where they are
checked finite. The window runs from a synchronised point to the read after
the last call dispatched before the time ran out; the frames over that time are
the end-to-end metric the mix names (``rate_metric``: ``train_img_s``, or
``train_img_s.graph`` where a call replays a CUDA graph, whose runs settle
in one of two rates and so take a bound of their own).

With ``--trace 1`` the window also times each call's dispatch on the host,
and ``trace_calls`` calls of the same traffic are profiled just before it
opens, so the profiler's start and reduction stay out of the window whose
wall time the host-clock metrics read. After the window
the program's state is freed and the plain reference follows the compared
calls from the same seed (:mod:`portbench.reference.follow`).
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import inputs, yardstick
from portbench.reference.follow import changes_of, follow, norms, state_shapes

LOSSES = ("loss_s", "loss_gf", "loss_gt")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi() -> str:
    """The card's SM and memory clocks, active clock event reasons, power
    draw, temperature and power limit."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,clocks_event_reasons.active,"
             "power.draw,temperature.gpu,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_losses(metrics: dict) -> list[float]:
    """The call's three losses on the host: one copy, which waits for it."""
    return torch.stack([metrics[k].float().reshape(()) for k in LOSSES]).cpu().tolist()


def build(config, traffic, seed, device, stage):
    """The program's fused iteration, its state and generators, and the
    initial weights; ``stage(name)`` marks the end of each set-up stage."""
    from dahpe_tpu_torch import models, parallel
    from dahpe_tpu_torch.data.device_store import DeviceDataStore
    from dahpe_tpu_torch.ops import _build, gaussian, pseudo_label, shear
    from dahpe_tpu_torch.train import create_da_state, make_fused_da_iteration

    stage("imports")
    if torch.device(device).type == "cuda":
        torch.empty(1, device=device)
        sync(device)
        stage("cuda_init")
        _build.load_all({m.LIB_NAME: m.SOURCES for m in (gaussian, pseudo_label, shear)})
    stage("kernel_load")
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[config["dtype"]]
    with torch.device(device):  # its own initialisation runs there, then is overwritten
        backbone = models.ResNet(getattr(models, config["block"]), config["layers"], dtype=dtype)
        model = models.MultiHeadPoseResNet(backbone, num_keypoints=config["num_keypoints"],
                                           feature_dim=config["feature_dim"],
                                           num_head_layers=config["num_head_layers"], dtype=dtype)
    sync(device)
    stage("model")
    weights = inputs.make_weights(state_shapes(config, device), seed, device)
    model.load_state_dict(weights)
    sync(device)
    stage("weights")
    state = create_da_state(model, device=device, with_ema=True,
                            momentum=traffic["momentum"], weight_decay=traffic["weight_decay"])
    state.step = traffic["start_step"]
    sync(device)
    stage("state")
    stores = [DeviceDataStore(inputs.FrameSource(inputs.make_frames(
        seed, d, config["store_frames"], config["raw_size"], config["num_keypoints"], device)),
        device=device, raw_size=config["raw_size"], verbose=False) for d in ("source", "target")]
    gens = [inputs.generator(seed, "stream-" + d, device) for d in ("source", "target")]
    sync(device)
    stage("stores")
    step_config = dict(base_lr=traffic["lr"], lr_gamma=traffic["lr_gamma"],
                       lr_decay=traffic["lr_decay"], trade_off=traffic["trade_off"],
                       momentum=traffic["momentum"], weight_decay=traffic["weight_decay"],
                       ema_decay=traffic["ema_decay"], conf_gate=None)
    step_config.update(parallel.data_parallel(model))
    fused = make_fused_da_iteration(
        model, stores[0], stores[1], traffic["batch"], image_size=config["image_size"],
        heatmap_size=config["heatmap_size"], rotation=traffic["rotation"],
        scale_range=tuple(traffic["scale_range"]), steps_per_call=traffic["steps_per_call"],
        **step_config)
    return fused, state, gens, weights


def program_readings(fused, state, gens, weights, calls: int) -> dict:
    """The compared calls: each call's losses, the momentum buffers' norms
    after the first, every tracked entry's change after the last."""
    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    losses, buffers = [], None
    for c in range(calls):
        state, metrics, _, _ = fused(state, *gens)
        losses.append(host_losses(metrics))
        if c == 0:
            buffers = norms({names[id(p)]: opt.state[p]["momentum_buffer"]
                             for opt in state.optimizers.values()
                             for group in opt.param_groups for p in group["params"]})
    from dahpe_tpu_torch.train.ema import ema_state

    changes = norms(changes_of(ema_state(model), state.ema, weights))
    return {"losses": np.asarray(losses, np.float64), "buffers": buffers, "changes": changes}


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap of norms, against the reference's norm of that leaf
    or of the median leaf of ``keys``, whichever is larger."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}


def readings(prog: dict, ref: dict) -> dict:
    """The numbers a training cell may compare, and the leaf that set each.

    ``loss_gap``: the largest relative gap of a call's loss, over every
    compared call (``loss_gap_first``: the first call's alone).
    ``grad_gap``: of a momentum buffer's norm after the first call,
    ``change_gap``: of a tracked entry's change after the last, each against
    the reference's norm of that leaf or of the median leaf of its group,
    whichever is larger; the worst leaf (``change_gap_median``: the median
    leaf's gap). Leaves whose first gradient in the reference is under a thousandth
    of the median leaf's (biases under batch norm) are left out of both, with
    their EMA twins."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    loss = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)
    loss[~np.isfinite(loss)] = math.inf
    g = ref["first_grads"]
    floor = 1e-3 * statistics.median(g.values())
    live = [k for k in g if g[k] >= floor]
    grad = _gaps(prog["buffers"], ref["buffers"], live)
    stats = [k for k in ref["changes"]
             if not k.startswith("ema:") and k.endswith(("running_mean", "running_var"))]
    change = {}
    for keys in (live, stats, ["ema:" + k for k in live + stats]):
        change.update(_gaps(prog["changes"], ref["changes"], keys))
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    return {"loss_gap": float(loss.max()), "loss_gap_first": float(loss[0].max()),
            "grad_gap": grad[worst_grad],
            "change_gap": change[worst_change],
            "change_gap_median": statistics.median(change.values()),
            "leaves": {"grad": worst_grad, "change": worst_change,
                       "excluded": sorted(set(g) - set(live))}}


def window(fused, state, gens, traffic, seconds, device, trace: bool) -> dict:
    """The timed window (module docstring). Besides the reads, a CUDA event
    is recorded after every ``evidence_iters`` iterations (no host wait), so
    the rate of each such chunk is known afterwards. A traced run profiles
    its slice just before the window opens, from and to a synchronised
    point, and reduces it before the clock starts."""
    k, every = int(traffic["steps_per_call"]), int(traffic["print_freq"])
    evidence = int(traffic["evidence_iters"])
    on_card = torch.device(device).type == "cuda"
    frames_per_iter = 2 * int(traffic["batch"])
    failed, profiled = 0, None
    if trace:
        profiled = profile_slice(fused, state, gens, traffic, device)
        failed += profiled["iters"] if not all(map(math.isfinite, profiled["losses"])) else 0
    dispatch, reads, marks = [], [], []
    step_start = state.step
    sync(device)
    t0 = time.perf_counter()
    log(f"window: opens at {time.time():.3f} (seconds since the epoch)")
    if on_card:
        marks.append((0, torch.cuda.Event(enable_timing=True)))
        marks[-1][1].record()
    deadline, iters, calls, since = t0 + seconds, 0, 0, 0
    metrics = None
    while time.perf_counter() < deadline:
        a = time.perf_counter()
        state, metrics, _, _ = fused(state, *gens)
        if trace:
            dispatch.append(time.perf_counter() - a)
        iters, calls, since = iters + k, calls + 1, since + k
        if on_card and iters % evidence == 0:
            marks.append((iters, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()
        if iters % every == 0:
            vals = host_losses(metrics)
            reads.append((time.perf_counter() - t0, iters, vals))
            failed += since if not all(map(math.isfinite, vals)) else 0
            since = 0
    if metrics is None:
        raise RuntimeError("the window dispatched no call: --seconds too short")
    if since:
        vals = host_losses(metrics)
        reads.append((time.perf_counter() - t0, iters, vals))
        failed += since if not all(map(math.isfinite, vals)) else 0
    sync(device)
    wall = time.perf_counter() - t0
    chunks = []
    for (i0, e0), (i1, e1) in zip(marks, marks[1:]):
        chunks.append(round((i1 - i0) * frames_per_iter / (e0.elapsed_time(e1) / 1e3), 2))
    return {"seconds": wall, "iters": iters, "calls": calls, "frames": iters * frames_per_iter,
            "failed": failed, "dispatch_s": dispatch, "chunk_img_s": chunks,
            "read_s": [round(t, 4) for t, _, _ in reads],
            "steps": [step_start, state.step], "trace": profiled}


def profile_slice(fused, state, gens, traffic, device) -> dict:
    """``trace_calls`` calls under ``torch.profiler``, from a synchronised
    point to the read after the last. On the card only the device's activity
    is traced (recording every host operation would slow the eager
    float32 loop's host below the card's pace); the host's calls and read
    are stamped on the wall clock the trace's times count from. One call and
    a synchronise come first inside the profiler and are left out: the first
    launch of a captured graph under the profiler carries the tracer's
    one-time set-up."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    n, k = int(traffic["trace_calls"]), int(traffic["steps_per_call"])
    stamps = []
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        state, metrics, _, _ = fused(state, *gens)
        host_losses(metrics)
        sync(device)
        for _ in range(n):
            a = time.time_ns()
            state, metrics, _, _ = fused(state, *gens)
            stamps.append(("call", a, time.time_ns()))
        a = time.time_ns()
        vals = host_losses(metrics)
        sync(device)
        stamps.append(("read", a, time.time_ns()))
    origin = prof.profiler.kineto_results.trace_start_ns()
    spans = [(name, (a - origin) / 1e3, (b - origin) / 1e3) for name, a, b in stamps]
    begin, finish = spans[0][1], spans[-1][2]
    device_events = [(e.name, max(e.time_range.start, begin), min(e.time_range.end, finish))
                     for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.time_range.end > begin and e.time_range.start < finish]
    reduced = yardstick.reduce_trace(device_events, spans, begin, finish)
    reduced.update(wall_s=(finish - begin) / 1e6, calls=n, iters=n * k, losses=vals,
                   launches={name: sum(1 for ev in device_events if name in ev[0])
                             for name in yardstick.PORT_KERNELS})
    return reduced


def prepare(config, traffic, seed, device, stage):
    """Set-up through the compared calls: ``(fused, state, gens, readings)``."""
    fused, state, gens, weights = build(config, traffic, seed, device, stage)
    prog = program_readings(fused, state, gens, weights, int(traffic["compared_calls"]))
    return fused, state, gens, prog


def run(*, config, traffic, seed, seconds, trace, device, stage) -> dict:
    fused, state, gens, prog = prepare(config, traffic, seed, device, stage)
    calls = int(traffic["compared_calls"])
    k = int(traffic["steps_per_call"])
    settle = int(traffic["settle_iters"]) // k
    on_card = torch.device(device).type == "cuda"
    total = max(settle, int(traffic["warmup_iters"]) // k - calls)
    for i in range(total):
        if i == total - settle:  # the card's state, read before the settling calls
            sync(device)
            before = smi() if on_card else "not measured"
        state, metrics, _, _ = fused(state, *gens)
    host_losses(metrics)
    stage("warmup_and_capture")
    win = window(fused, state, gens, traffic, seconds, device, trace)
    after = smi() if on_card else "not measured"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if win["trace"] is not None:
        top = sorted(win["trace"]["names_s"].items(), key=lambda kv: -kv[1])[:25]
        log("trace: top kernels (s, kind, name): " + json.dumps(
            [(round(v, 6), yardstick.kind_of(n), n[:110]) for n, v in top]))
    log(f"window: steps {win['steps'][0]} -> {win['steps'][1]}, {win['iters']} iterations in "
        f"{win['calls']} calls, {win['seconds']:.4f} s")
    log(f"window: img/s of each {traffic['evidence_iters']}-iteration chunk (CUDA events) "
        f"{win['chunk_img_s']}; host seconds of the reads {win['read_s']}")
    log(f"window: nvidia-smi clocks.sm, clocks.mem, clocks_event_reasons.active, power.draw, "
        f"temperature.gpu, power.limit: "
        f"before [{before}] after [{after}]")
    del fused, state, gens
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = follow(config, traffic, seed, device, calls)
    log(f"reference: {calls} calls followed in {time.perf_counter() - t:.1f} s")
    read = readings(prog, ref)
    log(f"compared leaves: {read['leaves']}")
    log(f"losses: program {prog['losses'].tolist()} reference {ref['losses'].tolist()}")
    limits = config["limits"]
    context = {"config": config, "traffic": traffic, "window": win, "trace": win["trace"]}
    end_to_end = {traffic["rate_metric"]: win["frames"] / win["seconds"]}
    breakdown = None
    if win["trace"] is not None:
        tr = win["trace"]
        breakdown = {"device_ops": sorted(tr["kinds_s"].items(), key=lambda kv: -kv[1])[:10],
                     "idle_gaps": [list(g) for g in tr["gaps"][:10]]}
        log(f"trace: {tr['iters']} iterations in {tr['wall_s']:.4f} s, busy {tr['busy_s']:.4f} s, "
            f"port kernel launches {tr['launches']}")
    log("readings: " + json.dumps({n: v for n, v in read.items() if n != "leaves"}))
    return {"attempted": win["iters"], "failed": win["failed"], "end_to_end": end_to_end,
            "context": context, "compared": {n: (read[n], limits[n]) for n in limits},
            "memory_peak_bytes": peak, "breakdown": breakdown,
            "busy_s": None if win["trace"] is None else win["trace"]["busy_s"],
            "window_s": None if win["trace"] is None else win["trace"]["wall_s"]}
