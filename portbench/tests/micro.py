"""A cell of ``BENCHMARK.json`` cut to a size a CPU test can run: one
Bottleneck a stage at 64² (16² heatmaps), 8 stored 72² frames a domain,
batches of 2, a few warm-up iterations. Widths and the traffic's settings
are the cell's own."""

import time

from portbench import harness

SEED = 2**31 + 12345
# the serving cell that BENCHMARK.json leaves for later (PERF.md, Open
# questions): its driver, reference and traffic mix are here and tested
SERVE_CELL = {"name": "serve_f32_c8x8", "config": "msf_r101_256_f32",
              "traffic": "serve_http_c8x8", "chips": 1}


def entry_of(cell) -> dict:
    """A cell of ``BENCHMARK.json`` by name, or a cell entry given whole."""
    return cell if isinstance(cell, dict) else harness.cell_of(harness.benchmark(), cell)


def micro(cell) -> tuple[dict, dict]:
    bench = harness.benchmark()
    entry = entry_of(cell)
    config = harness.config_of(bench, entry)
    config.update(layers=[1, 1, 1, 1], image_size=64, heatmap_size=16, raw_size=72,
                  store_frames=8)
    traffic = harness.traffic_of(entry["traffic"])
    if traffic["driver"] == "serve_http":  # the export CLI takes a named backbone
        config.update(layers=[3, 4, 6, 3])
        traffic.update(clients=2, frames_per_request=2, max_batch=4, frame_pool=16,
                       warm_rows=[2, 4], warmup_s=0.5, trace_prime_s=0.2, trace_s=0.5,
                       compared_requests=8)
        return config, traffic
    k = traffic["steps_per_call"]
    traffic.update(batch=2, print_freq=4 * k, evidence_iters=k, warmup_iters=2 * k,
                   settle_iters=k, trace_calls=1)
    return config, traffic


def micro_run(cell, *, trace: bool, seconds: float = 0.5, seed: int = SEED) -> dict:
    bench = harness.benchmark()
    config, traffic = micro(cell)
    return harness.run_cell(bench, entry_of(cell), seed=seed, seconds=seconds,
                            trace=trace, device="cpu", t_start=time.perf_counter(),
                            config=config, traffic=traffic)
