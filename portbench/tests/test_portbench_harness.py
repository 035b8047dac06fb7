"""CPU tests of the benchmark harness: the result line, finding every piece
by name, the import check, the yardstick's counts against hand counts, and
the plain reference against the port at a micro size.

Run: ``python -m pytest portbench/tests -q`` from the repository root."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, yardstick
from portbench.tests.micro import SERVE_CELL, entry_of, micro_run

BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
# every driver: the cells, and the serving cell left for later
DRIVEN = [*CELLS, SERVE_CELL]
IDS = [entry_of(c)["name"] for c in DRIVEN]


@pytest.mark.parametrize("cell", DRIVEN, ids=IDS)
def test_result_line_keys_and_types(cell):
    result = micro_run(cell, trace=False)
    assert list(result)[-1] == "compared"
    for key, kind in (("correct", bool), ("attempted", int), ("failed", int),
                      ("metrics", dict), ("device", dict)):
        assert isinstance(result[key], kind), key
    e2e, _ = harness.cell_metrics(BENCH, entry_of(cell)["name"])
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics_and_breakdown(cell):
    result = micro_run(cell, trace=True)
    _, layers = harness.cell_metrics(BENCH, cell)
    # host-clock metrics are read on the CPU too; the device's are left out
    assert {m["name"] for m in layers if m["source"] == "host_clock"} <= set(result["metrics"])
    assert set(result["metrics"]) <= {m["name"] for m in layers}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would run the cell")
    assert harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_pieces_found_by_name_from_files():
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in names
        config = harness.config_of(BENCH, cell)
        assert config["name"] == cell["config"] and config["limits"]
        traffic = harness.traffic_of(cell["traffic"])
        driver = __import__("portbench.drivers." + traffic["driver"], fromlist=["run"])
        assert callable(driver.run)
    cells = set(CELLS)
    for m in BENCH["per_layer"]:
        mod = harness.reader(m["name"])
        assert callable(mod.read) and mod.MOVES == m["moves"]
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells
    for cell in CELLS:  # every cell reports setup_s, another end-to-end and a per-layer metric
        e2e, layers = harness.cell_metrics(BENCH, cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers


def test_forbidden_modules_compared_by_whole_top_level_name():
    assert harness.forbidden_loaded(["dahpe_tpu_torch", "dahpe_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "jaxlib", "dahpe_tpu.core"]) == [
        "dahpe_tpu", "jax", "jaxlib"]
    assert harness.forbidden_loaded(["jaxtyping", "flaxen", "benchmarks"]) == []


def test_reference_and_yardstick_import_no_program_and_no_jax():
    code = ("import sys; import portbench.reference.follow, portbench.yardstick, "
            "portbench.inputs; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "dahpe_tpu", "dahpe_tpu_torch"}


def test_a_micro_run_loads_no_jax():
    code = ("import json, sys, time; from portbench import harness; "
            "from portbench.tests.micro import micro_run; micro_run('train_bf16_k4', trace=False); "
            "print(json.dumps(harness.forbidden_loaded()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _conv(out_hw, cout, cin, k):
    return out_hw * out_hw * cout * cin * k * k


def test_flops_against_a_hand_count():
    """ResNet of one Bottleneck a stage at 64²: every convolution by hand."""
    config = {"layers": [1, 1, 1, 1], "num_keypoints": 21, "feature_dim": 256, "image_size": 64}
    stem = _conv(32, 64, 3, 7)
    stages, cin, hw = 0, 64, 16
    for planes, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        out = hw // stride
        stages += (_conv(hw, planes, cin, 1) + _conv(out, planes, planes, 3)
                   + _conv(out, planes * 4, planes, 1) + _conv(out, planes * 4, cin, 1))
        cin, hw = planes * 4, out
    deconv = 2 * 2 * 2048 * 256 * 16 + 4 * 4 * 256 * 256 * 16 + 8 * 8 * 256 * 256 * 16
    head = _conv(16, 256, 256, 3) + _conv(16, 21, 256, 1)
    fusion = lambda fhw, stride: (  # noqa: E731
        _conv(fhw, 256, 21, 1) + (_conv(fhw, 256, 256, 1) if stride == 1
                                  else _conv(fhw, 256, 256, 3))
        + _conv(fhw // 2, 256, 256, 3) + _conv(fhw // 2, 256, 256, 1)
        + _conv(fhw // 2, 256, 256, 3) + _conv(fhw // 2, 21, 256, 1))
    adv = head + fusion(16, 1) + fusion(8, 2)
    parts = yardstick.flops_by_part(config)
    assert parts == {"features": 2 * (stem + stages + deconv), "head": 2 * head, "adv": 2 * adv}
    b = 3
    assert yardstick.flops_per_da_iteration(config, b) == b * (
        3 * (parts["features"] + parts["head"] + parts["adv"])
        + 3 * parts["features"] + parts["head"] + 6 * parts["adv"])
    assert yardstick.flops_per_frame(config) == parts["features"] + parts["head"]


def test_bounds_against_a_hand_count():
    ms, kind = yardstick.rotation_bound_ms(2, 8, 3)
    assert kind == "bytes" and math.isclose(ms, (128 * 3 * 5 + 24) / 3.35e12 * 1e3)
    ops_ms = 128 * (49 + 3 * 36) / 67e12 * 1e3
    assert ms > ops_ms
    ms, kind = yardstick.labels_bound_ms(2, 4, 3, "union_minus", True, True)
    assert kind == "bytes" and math.isclose(ms, (2 * 3 * 8 + 96 * 4 + 96 * 4) / 3.35e12 * 1e3)
    ms, _ = yardstick.labels_bound_ms(2, 4, 3, "inverse", False, False, with_gt=True)
    assert math.isclose(ms, (48 + 2 * 96 * 4) / 3.35e12 * 1e3)
    total = yardstick.da_labels_bound_ms(2, 16, 3)
    assert math.isclose(total, sum(yardstick.labels_bound_ms(2, s, 3, k, f, n)[0] for s, k, f, n in
                                   ((16, "union_minus", True, True), (8, "inverse", True, True),
                                    (4, "inverse", False, False))))


def test_reduce_trace_busy_gaps_and_kinds():
    events = [("cudnn::batchnorm_fwtr_nhwc", 10.0, 20.0), ("sm90_xmma_fprop", 15.0, 30.0),
              ("vectorized_elementwise_kernel", 40.0, 50.0)]
    spans = [("call", 0.0, 35.0), ("read", 35.0, 60.0)]
    r = yardstick.reduce_trace(events, spans, 0.0, 60.0)
    assert math.isclose(r["busy_s"], 30e-6)
    assert r["kinds_s"] == pytest.approx({"batch_norm": 10e-6, "convolution": 15e-6,
                                          "other": 10e-6})
    assert r["gaps"] == [("call", 10e-6), ("read", 10e-6), ("read", 10e-6)]


@pytest.mark.parametrize("cell", DRIVEN, ids=IDS)
def test_reference_follows_the_port_at_a_micro_size(cell):
    result = micro_run(cell, trace=False)
    assert result["correct"] and result["failed"] == 0
    for name, c in result["compared"].items():
        assert c["value"] < 1e-5, name
