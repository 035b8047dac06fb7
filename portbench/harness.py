"""The benchmark's harness: one run of one cell, found by name.

``BENCHMARK.json`` names the cell; the cell names its configuration (a file
under ``portbench/configs/``) and its traffic mix (``portbench/traffic/<mix>.json``,
whose ``driver`` names the general driver under ``portbench/drivers/``
that reads it). Each per-layer metric is a reader of its own,
``portbench/metrics/<metric>.py``, whose ``read(context)`` returns a number
or None. Adding a cell, a configuration, a mix or a metric adds files and
entries; nothing here changes.

The last line of standard output is the run's result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number compared with its limit).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names that must not be loaded in a run: JAX and the JAX
# package, and the JAX package's benchmark entry points
FORBIDDEN = ("jax", "jaxlib", "flax", "dahpe_tpu", "bench", "__graft_entry__")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return load_json(os.path.join(ROOT, entry["file"]))


def traffic_of(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def reader(metric: str):
    """The per-layer metric's reader module, by the metric's name."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The cell's end-to-end metrics and the per-layer metrics it reports:
    those that list it, and those that list no cells but move one of its
    end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if ((cell in m["workloads"]) if "workloads" in m else m["moves"] in moved)]
    return e2e, layers


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of ``cell``; returns the result object (not printed)."""
    config = config_of(bench, cell) if config is None else config
    traffic = traffic_of(cell["traffic"]) if traffic is None else traffic
    driver = importlib.import_module("portbench.drivers." + traffic["driver"])
    stages, last = {}, [t_start]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    out = driver.run(config=config, traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                     device=device, stage=stage)
    setup_s = sum(stages.values())
    print(f"setup_s by stage: {json.dumps({k: round(v, 4) for k, v in stages.items()})}",
          file=sys.stderr, flush=True)
    e2e, layers = cell_metrics(bench, cell["name"])
    values = dict(out["end_to_end"], setup_s=setup_s)
    metrics = {}
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in layers:
            v = reader(m["name"]).read(out["context"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    compared = {n: {"value": v, "limit": lim} for n, (v, lim) in out["compared"].items()}
    within = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": bool(within and out["failed"] == 0 and out["attempted"] > 0),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device_record(device, out["memory_peak_bytes"])}
    if trace and out.get("busy_s") is not None:
        result["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
    if trace and out.get("breakdown") is not None:
        result["breakdown"] = out["breakdown"]
    result["compared"] = compared
    return result


def device_record(device: str, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="run one cell of BENCHMARK.json once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = benchmark()
    cell = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=t_start)
    found = forbidden_loaded()
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
