"""Runs the port's HTTP server, ``python -m dahpe_tpu_torch.cli.serve``, in
this process so a traced benchmark run can profile it:

    python3 portbench/serve_shim.py <summary.json> <prime_s> -- <cli.serve arguments>

SIGUSR1 starts ``torch.profiler`` (device activity only); SIGUSR2 stops it,
reduces the device's kernels after the first ``prime_s`` seconds with the
yardstick (busy time, kinds, idle gaps) and writes ``summary.json``. Without
the signals the server runs exactly as the CLI runs it."""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]


def main() -> None:
    import signal

    import torch

    from dahpe_tpu_torch.cli import serve
    from portbench import yardstick

    summary, prime_s, args = sys.argv[1], float(sys.argv[2]), sys.argv[4:]
    state = {}

    def start(*_):
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                   else ProfilerActivity.CPU])
        prof.start()
        state.update(prof=prof, t0=time.time_ns())

    def stop(*_):
        prof, t1 = state.pop("prof"), time.time_ns()
        prof.stop()
        origin = prof.profiler.kineto_results.trace_start_ns()
        begin, finish = (state["t0"] - origin) / 1e3 + prime_s * 1e6, (t1 - origin) / 1e3
        events = [(e.name, max(e.time_range.start, begin), min(e.time_range.end, finish))
                  for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.end > begin and e.time_range.start < finish]
        out = yardstick.reduce_trace(events, [], begin, finish)
        out.update(wall_s=(finish - begin) / 1e6, kernels=len(events))
        with open(summary + ".tmp", "w") as fh:
            json.dump(out, fh)
        os.replace(summary + ".tmp", summary)

    signal.signal(signal.SIGUSR1, start)
    signal.signal(signal.SIGUSR2, stop)
    serve.main(serve.build_serve_parser().parse_args(args))


if __name__ == "__main__":
    main()
