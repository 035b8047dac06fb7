"""PyTorch port, the HTTP serving CLI (``dahpe_tpu_torch.cli.serve``) and its
client (``dahpe_tpu_torch.client``): real servers on an ephemeral port of
the loopback, driven over HTTP (counterpart of ``tests/test_serve_cli.py``).

On the CPU the server runs the artifact eagerly; on the card it replays one
CUDA graph per padded batch (``chip_smoke.py`` phase 7). Every server here
listens on port 0, every connection has a socket timeout, every join a
timeout, and every subprocess a ``timeout=``, so no test can hang the suite.
"""

import contextlib
import io
import json
import os
import queue
import signal
import subprocess
import sys
import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT
from tests.test_torch_port_models import model_pair

from dahpe_tpu_torch import quant, serving
from dahpe_tpu_torch.cli.serve import (
    _pad_target,
    _pow2_bucket,
    build_serve_parser,
    create_server,
)
from dahpe_tpu_torch.client import PoseClient, ServeError

IMAGE, HEATMAP = 64, 16
TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several test files in parallel
    processes, and torch's default of one thread per core oversubscribes
    the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A mini model exported three ways: float32 at batch 8, uint8 ingest
    batch-polymorphic, and int8 at batch 4; each beside its weights."""
    _, _, model = model_pair("basic", image_size=IMAGE, seed=2)
    root = tmp_path_factory.mktemp("serve")
    geometry = dict(image_size=IMAGE, heatmap_size=HEATMAP, device="cpu")
    out = {}
    for name, kw in (("fixed8", dict(batch_size=8)),
                     ("uint8_poly", dict(batch_size=None, uint8_input=True))):
        out[name] = str(root / f"{name}.pt2")
        serving.save_predict(out[name], model, **kw, **geometry)
        serving.save_variables_npz(out[name] + ".weights.npz", model)
    calib = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, IMAGE, IMAGE, 3)).astype(np.float32))
    qtree = quant.quantize_model(model, calib)
    out["int8"] = str(root / "int8.pt2")
    with open(out["int8"], "wb") as f:
        f.write(serving.export_predict_int8(qtree, batch_size=4, **geometry))
    serving.save_quantized_npz(out["int8"] + ".weights.npz", qtree)
    return out


@contextlib.contextmanager
def running(artifact, *flags):
    """A server on an ephemeral loopback port, serving on a daemon thread."""
    server = create_server(build_serve_parser().parse_args(
        [artifact, "--port", "0", "--device", "cpu", *flags]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive()


def _direct(artifact, frames):
    """The artifact called directly on ``frames``: ``(coords, maxvals)``."""
    predict = serving.load_predict_file(artifact, device="cpu")
    weights = serving.load_artifact_weights(artifact + ".weights.npz")
    coords, maxvals = predict(weights, torch.from_numpy(frames))
    return coords.numpy(), maxvals.numpy()[..., 0]


def _post_npy(port, path, arr):
    conn = HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        buf = io.BytesIO()
        np.save(buf, arr)
        conn.request("POST", path, body=buf.getvalue())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _frames(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
    return rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)


def test_pow2_bucket_and_pad_target():
    assert [_pow2_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert _pad_target(5, 8) == 8          # a fixed batch always wins
    assert _pad_target(3, None) == 4       # the pow2 bucket
    assert _pad_target(1, None, 8) == 8    # rounded up to the device count
    assert _pad_target(9, None, 8) == 16
    assert _pad_target(5, None, 6) == 12


def test_http_contract(artifacts):
    """200 with the padded batch's live rows, 413 over the compiled batch,
    400 for a bad shape, 404 for an unknown route, and the typed client."""
    artifact = artifacts["fixed8"]
    with running(artifact) as server:
        port = server.server_address[1]
        status, health = _get(port, "/healthz")
        assert status == 200 and health["batch"] == 8 and health["kind"] == "float"
        assert health["frame_shape"] == [IMAGE, IMAGE, 3] and health["devices"] == ["cpu"]

        frames = _frames(3, seed=0)
        status, out = _post_npy(port, "/predict", frames)
        assert status == 200
        coords = np.asarray(out["coords"])
        assert coords.shape == (3, 21, 2) and np.asarray(out["maxvals"]).shape == (3, 21)
        padded = np.concatenate([frames, np.zeros((5, IMAGE, IMAGE, 3), np.float32)])
        np.testing.assert_array_equal(coords, _direct(artifact, padded)[0][:3])

        status, out = _post_npy(port, "/predict", np.zeros((9, IMAGE, IMAGE, 3), np.float32))
        assert status == 413 and "polymorphic" in out["error"]
        status, _ = _post_npy(port, "/predict", np.zeros((2, 32, 32, 3), np.float32))
        assert status == 400
        assert _get(port, "/nope")[0] == 404
        assert _post_npy(port, "/nope", frames)[0] == 404

        with PoseClient("127.0.0.1", port, timeout=TIMEOUT) as client:
            assert client.health()["batch"] == 8
            c2, m2 = client.predict(frames)
            np.testing.assert_array_equal(c2, coords.astype(np.float32))
            assert m2.shape == (3, 21)
            with pytest.raises(ServeError) as err:
                client.predict(np.zeros((9, IMAGE, IMAGE, 3), np.float32))
            assert err.value.status == 413
        assert _get(port, "/healthz")[1]["requests"] == 2


def test_polymorphic_uint8_pads_to_pow2_buckets(artifacts):
    """A batch-polymorphic uint8 artifact takes any request batch, padded to
    the next power of two (padding never changes the live rows), and
    refuses float frames with 400."""
    artifact = artifacts["uint8_poly"]
    with running(artifact) as server:
        servable, port = server.servable, server.server_address[1]
        assert servable.batch is None and _get(port, "/healthz")[1]["dtype"] == "uint8"
        dispatched = []
        original = servable.predict

        def recording(weights, frames):
            dispatched.append(frames.shape[0])
            return original(weights, frames)

        servable.mesh.predicts[0] = recording
        frames = _frames(5, seed=2, dtype=np.uint8)
        status, out = _post_npy(port, "/predict", frames)
        assert status == 200 and dispatched == [8]
        np.testing.assert_array_equal(np.asarray(out["coords"]), _direct(artifact, frames)[0])
        assert _post_npy(port, "/predict", frames[:4])[0] == 200
        assert dispatched == [8, 4]
        status, out = _post_npy(port, "/predict", np.zeros((2, IMAGE, IMAGE, 3), np.float32))
        assert status == 400 and "uint8" in out["error"]


def test_dynamic_batching_coalesces(artifacts):
    """Four concurrent batch-2 requests against a batch-8 artifact coalesce
    into one dispatch (the batcher fills the compiled batch), and each client
    gets its own rows. The 30 s window only bounds the wait if a client
    dies."""
    artifact = artifacts["fixed8"]
    with running(artifact, "--batch-window", "30000") as server:
        port = server.server_address[1]
        payloads = [_frames(2, seed=10 + i) for i in range(4)]
        results = [None] * 4

        def client(i):
            results[i] = _post_npy(port, "/predict", payloads[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        for i, (status, out) in enumerate(results):
            assert status == 200
            solo = np.concatenate([payloads[i], np.zeros((6, IMAGE, IMAGE, 3), np.float32)])
            np.testing.assert_array_equal(np.asarray(out["coords"]),
                                          _direct(artifact, solo)[0][:2])
        health = _get(port, "/healthz")[1]
        assert health["requests"] == 4 and health["batches"] == 1


def test_batching_oversize_polymorphic_request_dispatches_solo(artifacts):
    artifact = artifacts["uint8_poly"]
    with running(artifact, "--batch-window", "50", "--max-batch", "4") as server:
        port = server.server_address[1]
        frames = _frames(6, seed=4, dtype=np.uint8)
        status, out = _post_npy(port, "/predict", frames)  # 6 > cap 4
        assert status == 200
        np.testing.assert_array_equal(np.asarray(out["coords"]), _direct(artifact, frames)[0])
        status, out = _post_npy(port, "/predict", frames[:2])
        assert status == 200 and np.asarray(out["coords"]).shape == (2, 21, 2)


@pytest.mark.parametrize("mode", ["direct", "batched"])
def test_dispatch_error_is_500(artifacts, mode):
    """A device failure on a well-formed request answers 500, a malformed
    request during the fault still 400, and the server recovers."""
    flags = ["--batch-window", "20"] if mode == "batched" else []
    with running(artifacts["fixed8"], *flags) as server:
        port, servable = server.server_address[1], server.servable
        original = servable.predict

        def failing(weights, frames):
            raise RuntimeError("CUDA error: out of memory (simulated)")

        servable.mesh.predicts[0] = failing
        frames = np.zeros((2, IMAGE, IMAGE, 3), np.float32)
        status, out = _post_npy(port, "/predict", frames)
        assert status == 500 and "out of memory" in out["error"]
        assert _post_npy(port, "/predict", np.zeros((2, 32, 32, 3), np.float32))[0] == 400
        servable.mesh.predicts[0] = original
        status, out = _post_npy(port, "/predict", frames)
        assert status == 200 and np.asarray(out["coords"]).shape == (2, 21, 2)


def test_int8_artifact_serves(artifacts):
    artifact = artifacts["int8"]
    with running(artifact) as server:
        port = server.server_address[1]
        health = _get(port, "/healthz")[1]
        assert health["batch"] == 4 and health["kind"] == "int8"
        frames = _frames(4, seed=5)
        status, out = _post_npy(port, "/predict", frames)
        assert status == 200
        np.testing.assert_array_equal(np.asarray(out["coords"]), _direct(artifact, frames)[0])


def test_close_drains_in_flight_requests(artifacts):
    """``server_close`` joins in-flight handler threads: a request accepted
    before shutdown completes instead of being cut mid-dispatch."""
    server = create_server(build_serve_parser().parse_args(
        [artifacts["fixed8"], "--port", "0", "--device", "cpu"]))
    assert server.daemon_threads is False
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    entered, release = threading.Event(), threading.Event()
    original = server.servable.predict

    def slow(weights, frames):
        entered.set()
        release.wait(timeout=TIMEOUT)
        return original(weights, frames)

    server.servable.mesh.predicts[0] = slow
    result = {}
    client = threading.Thread(target=lambda: result.update(
        reply=_post_npy(port, "/predict", np.zeros((2, IMAGE, IMAGE, 3), np.float32))))
    client.start()
    assert entered.wait(timeout=TIMEOUT)
    server.shutdown()  # stop accepting; the in-flight request lives on
    closer = threading.Thread(target=server.server_close)
    closer.start()
    closer.join(timeout=1.0)
    assert closer.is_alive()  # close blocks on the in-flight handler
    release.set()
    closer.join(timeout=TIMEOUT)
    client.join(timeout=TIMEOUT)
    thread.join(timeout=TIMEOUT)
    assert not closer.is_alive() and not client.is_alive() and not thread.is_alive()
    status, out = result["reply"]
    assert status == 200 and np.asarray(out["coords"]).shape == (2, 21, 2)


def _env():
    return dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="2")


def test_sigterm_drains_and_exits_zero(artifacts):
    """``python -m dahpe_tpu_torch.cli.serve``: prints its address, answers,
    and on SIGTERM stops accepting, drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dahpe_tpu_torch.cli.serve", artifacts["fixed8"], "--port", "0",
         "--device", "cpu"], cwd=REPO_ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        while True:
            line = lines.get(timeout=120)
            if line.startswith("serving "):
                break
        port = int(line.rsplit(":", 1)[1].split()[0])
        with PoseClient("127.0.0.1", port, timeout=TIMEOUT) as client:
            coords, _ = client.predict(_frames(2, seed=6))
        assert coords.shape == (2, 21, 2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT) == 0
        reader.join(timeout=TIMEOUT)
        rest = []
        while not lines.empty():
            rest.append(lines.get_nowait())
        assert any(ln.startswith("drained: 1 requests in 1 batches") for ln in rest), rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


def test_mesh_is_refused(artifacts):
    """``--mesh`` was refused until the parallel slice ported it; it now
    starts, splits over the host's devices (the CPU: one) and answers as the
    server without it does."""
    frames = np.random.default_rng(3).standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    answers = []
    for extra in ((), ("--mesh",)):
        server = create_server(build_serve_parser().parse_args(
            [artifacts["fixed8"], "--port", "0", "--device", "cpu", *extra]))
        try:
            answers.append(server.servable.run(frames))
            assert server.servable.info()["devices"] == ["cpu"]
        finally:
            server.server_close()
    assert answers[0] == answers[1]


def test_mesh_splits_each_batch_over_two_devices(artifacts, monkeypatch):
    """``--mesh`` over two devices (the CPU twice, in place of two cards):
    the artifact loaded once a device, each padded batch split into equal
    chunks and gathered on the first; the answers equal the server's
    without ``--mesh`` bit for bit, a 1- and a 3-frame request padded to an
    even bucket. A fixed-batch artifact is refused over several devices."""
    from dahpe_tpu_torch.cli import serve

    monkeypatch.setattr(serve, "create_mesh", lambda: [torch.device("cpu")] * 2)
    artifact = artifacts["uint8_poly"]
    servers = [create_server(build_serve_parser().parse_args(
        [artifact, "--port", "0", "--device", "cpu", *extra])) for extra in ((), ("--mesh",))]
    try:
        mesh = servers[1].servable
        assert mesh.info()["devices"] == ["cpu", "cpu"] and len(mesh.mesh.predicts) == 2
        assert mesh.mesh.predicts[0] is not mesh.mesh.predicts[1]
        for n in (1, 3, 8):
            frames = _frames(n, seed=20 + n, dtype=np.uint8)
            (c0, m0), (c1, m1) = [s.servable.run_arrays(frames) for s in servers]
            assert c1.shape == (n, 21, 2)
            np.testing.assert_array_equal(c1, c0)
            np.testing.assert_array_equal(m1, m0)
    finally:
        for s in servers:
            s.server_close()
    with pytest.raises(SystemExit, match="batch-polymorphic"):
        create_server(build_serve_parser().parse_args(
            [artifacts["fixed8"], "--port", "0", "--device", "cpu", "--mesh"]))


def test_client_needs_no_torch():
    """The client imports the standard library and numpy only."""
    code = ("import sys; sys.modules['torch'] = None\n"
            "from dahpe_tpu_torch.client import PoseClient, ServeError\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_client_non_json_error_bodies():
    """Replies produced outside the endpoint's JSON path (an HTML error page,
    a proxy's non-JSON 200) surface as ``ServeError``, never a
    ``JSONDecodeError``."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class OddHandler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = b"<html>not json</html>"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_error(503, "upstream unavailable")

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), OddHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with PoseClient("127.0.0.1", server.server_address[1], timeout=TIMEOUT) as client:
            with pytest.raises(ServeError, match="non-JSON") as err:
                client.health()
            assert err.value.status == 200
            with pytest.raises(ServeError, match="Error response") as err:
                client.predict(np.zeros((1, 8, 8, 3), np.float32))
            assert err.value.status == 503
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)
