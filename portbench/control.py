"""The readings that set a cell's limits, in one process:

    python3 portbench/control.py --workload <cell> --seeds 12 --base <n> [--controls 3] [--faults 3]

For each of ``--seeds`` seeds (``base``, ``base + 1``, ...) the program
runs as a benchmark run does and the plain reference reads its numbers (the
lower readings): a training cell's set-up through the compared calls, a
serving cell's whole run with a window of ``--seconds``. On the first
``--controls`` seeds the reference in the precision below the
configuration's (the control) is read against the reference, and for a
training cell on the first ``--faults`` seeds the reference with half of
each batch left out (the upper readings). One JSON line per reading; needs
the card.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]


def main(argv=None) -> int:
    import argparse
    import gc
    import json
    import time

    import torch

    from portbench import harness
    from portbench.drivers import da_train
    from portbench.reference.follow import follow

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--base", type=int, required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    config, traffic = harness.config_of(bench, cell), harness.traffic_of(cell["traffic"])
    if traffic["driver"] == "serve_http":
        return serving(config, traffic, args)
    calls = int(traffic["compared_calls"])

    def emit(kind, seed, prog, ref):
        r = da_train.readings(prog, ref)
        print(json.dumps({"workload": cell["name"], "kind": kind, "seed": seed,
                          **{n: v for n, v in r.items() if n != "leaves"},
                          "leaves": {n: r["leaves"][n] for n in ("grad", "change")}}), flush=True)

    for i in range(args.seeds):
        seed = args.base + i
        t = time.perf_counter()
        fused, state, gens, prog = da_train.prepare(config, traffic, seed, "cuda", lambda _: None)
        del fused, state, gens
        gc.collect()
        torch.cuda.empty_cache()
        ref = follow(config, traffic, seed, "cuda", calls)
        emit("program", seed, prog, ref)
        if i < args.controls:
            emit("control_" + config["control"], seed,
                 follow(config, traffic, seed, "cuda", calls, control=config["control"]), ref)
        if i < args.faults:
            emit("fault_half_batch", seed, follow(config, traffic, seed, "cuda", calls,
                                                  fault="half"), ref)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


def serving(config, traffic, args) -> int:
    import json
    import time

    import torch

    from portbench import inputs
    from portbench.drivers import serve_http
    from portbench.reference.serve import ServeReference

    scale = config["image_size"] / config["heatmap_size"]
    for i in range(args.seeds):
        seed = args.base + i
        t = time.perf_counter()
        out = serve_http.run(config=config, traffic=traffic, seed=seed, seconds=args.seconds,
                             trace=False, device="cuda", stage=lambda _: None)
        print(json.dumps({"workload": args.workload, "kind": "program", "seed": seed,
                          **{n: v for n, (v, _) in out["compared"].items()},
                          "requests": out["attempted"], "failed": out["failed"]}), flush=True)
        if i < args.controls:
            pool = inputs.make_frames(seed, "serve", int(traffic["frame_pool"]),
                                      config["image_size"], config["num_keypoints"],
                                      "cuda")["images"].cpu().numpy()
            sample = [(idx, None, None) for idx in out["context"]["sample"]]
            read = serve_http.compare(ServeReference(config, seed, "cuda"), pool, sample, scale,
                                      control=config["control"])
            print(json.dumps({"workload": args.workload, "kind": "control_" + config["control"],
                              "seed": seed, **read}), flush=True)
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
