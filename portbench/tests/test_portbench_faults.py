"""A run with the timed path broken underneath must come out not correct,
and so must the control: the reference in the precision below the
configuration's, put in the program's place.

Each fault is planted in the port, the harness's look for a chip is
skipped, and the rest of the run goes as on the card (``micro_run``). A
training cell: the step that returns its state unchanged, and half of each
batch left out with the means taken over the rest (it produces no answers
one by one). The serving cell: an answer altered where it is produced, and
half of a dispatch's rows left out. No cell exchanges anything between
chips. The serving cell is not in ``BENCHMARK.json`` yet; its driver is
tested under the mix it would run. The TF32 control changes nothing on the
CPU and runs on the card only; the fp8 control runs here."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import da_train
from portbench.reference.follow import follow
from portbench.tests.micro import SEED, SERVE_CELL, micro, micro_run

BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]
         if harness.traffic_of(c["traffic"])["driver"] == "da_train"]


def _fails(result: dict) -> bool:
    return not result["correct"] and any(c["value"] > c["limit"]
                                         for c in result["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    from dahpe_tpu_torch.train import optim

    monkeypatch.setattr(optim, "sgd_update", lambda *a, **k: None)
    assert _fails(micro_run(cell, trace=False))


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_not_correct(cell, monkeypatch):
    from dahpe_tpu_torch.data.device_store import DeviceDataStore

    whole = DeviceDataStore.traced_batch_fn

    def halved(self, batch_size, **cfg):
        produce = whole(self, batch_size, **cfg)
        return lambda g: {k: v[: batch_size // 2] for k, v in produce(g).items()}

    monkeypatch.setattr(DeviceDataStore, "traced_batch_fn", halved)
    assert _fails(micro_run(cell, trace=False))


@pytest.mark.parametrize("cell", CELLS)
def test_training_control_is_not_correct(cell):
    config, traffic = micro(cell)
    device = "cpu"
    if config["control"] == "tf32":
        if not torch.cuda.is_available():
            pytest.skip("TF32 exists on the card only")
        device = "cuda"
    calls = traffic["compared_calls"]
    ref = follow(config, traffic, SEED, device, calls)
    ctl = follow(config, traffic, SEED, device, calls, control=config["control"])
    read = da_train.readings(ctl, ref)
    assert any(read[n] > limit for n, limit in config["limits"].items()), read


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_serving_fault_is_not_correct(fault, monkeypatch):
    """An answer altered where the server produces it, and half of each
    dispatch's rows left out (answered with the other half's)."""
    from portbench.drivers import serve_http

    whole = serve_http.server_command
    script = __file__.replace("test_portbench_faults.py", "faulty_serve.py")

    def planted(*args):
        cmd = whole(*args)
        return [cmd[0], script, fault] + cmd[2:]

    monkeypatch.setattr(serve_http, "server_command", planted)
    assert _fails(micro_run(SERVE_CELL, trace=False, seconds=2.0))


def test_serving_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("the serving configuration's control is TF32, which exists on the card only")
    from portbench import inputs
    from portbench.drivers import serve_http
    from portbench.reference.serve import ServeReference

    config, traffic = micro(SERVE_CELL)
    pool = inputs.make_frames(SEED, "serve", 64, config["image_size"], config["num_keypoints"],
                              "cuda")["images"].cpu().numpy()
    sample = [(np.arange(i, i + 8), None, None) for i in range(0, 64, 8)]
    read = serve_http.compare(ServeReference(config, SEED, "cuda"), pool, sample,
                              config["image_size"] / config["heatmap_size"], control="tf32")
    assert any(read[n] > limit for n, limit in traffic["limits"].items()), read
