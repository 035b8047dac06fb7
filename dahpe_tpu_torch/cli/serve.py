"""HTTP serving CLI — a production endpoint around an exported artifact.

Port of ``dahpe_tpu/cli/serve.py``.
``python -m dahpe_tpu_torch.cli.serve model.pt2 --port 8000`` loads an
exported artifact (``cli.export``; float or ``--int8``) with its sibling
``.weights.npz`` and serves keypoint predictions over HTTP, on ``--device``
(default ``cuda``; the artifact must have been exported there).

Protocol (the JAX package's; :mod:`dahpe_tpu_torch.client` speaks it):

- ``GET /healthz`` → JSON: artifact geometry (batch/frame shape/dtype), the
  device, the captured batches and the counters: ``requests`` and
  ``batches``; ``rows`` and ``dispatch_s``, the live rows and host seconds
  of the device dispatches; ``queue_wait_s`` and ``queue_wait_max_s``, the
  sum and the largest of the batched requests' waits from enqueue to the
  start of their dispatch.
- ``POST /predict`` with an ``.npy`` body (``numpy.save`` of a ``(B, H, W,
  3)`` frame array of the artifact's input dtype) → JSON ``{"coords": (B,
  K, 2) image px, "maxvals": (B, K)}``.

Fixed-batch artifacts accept any request ``B ≤ batch`` (padded to the
compiled batch, the response truncated); above it the answer is 413.
Batch-polymorphic artifacts pad each dispatch to the next power of two, so
the set of padded batches stays bounded. On the card each padded batch runs
as one CUDA graph, captured under the dispatch lock: at warm-up for a
fixed-batch artifact, at a bucket's first use for a polymorphic one (where
the JAX package compiles). The graphs have static input and output buffers
and share one memory pool, which is safe because a replay's outputs are
copied to the host before the lock is released. A failed capture answers
500; nothing falls back to eager execution. On the CPU the artifact runs
eagerly. A server on the card sets cuDNN deterministic, so one request
always gets the same answer.

``--mesh`` splits every padded batch into one equal chunk per local card
(``serving.MeshPredict``): the artifact is loaded for each card and the
weights put on each card once, each card runs its chunk as its own CUDA
graph (one per card and bucket), and the coordinates and confidences are
gathered on the first card. On a host with one card it is the
single-device server.

``--batch-window MS`` turns on dynamic batching: a collector thread
coalesces concurrent requests into one dispatch, when the compiled batch
(or ``--max-batch``) fills or MS milliseconds after the first queued
request. ``SIGTERM`` stops accepting, finishes the requests in flight and
exits 0.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device
from dahpe_tpu_torch.parallel import create_mesh


class DispatchError(RuntimeError):
    """A server-side device-dispatch failure (a CUDA error, a failed capture,
    out of memory). Distinct from request-contract violations so the handler
    answers 500 — a client with a well-formed request must not be told 400
    during a server fault (retry logic keys on 4xx-vs-5xx)."""


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: padding polymorphic dispatches to pow2
    buckets bounds the captured graphs to log2(max) instead of one per
    observed size."""
    return 1 << max(0, (n - 1).bit_length())


def _pad_target(n: int, compiled_batch: int | None, n_devices: int = 1) -> int:
    """Rows to pad an ``n``-row request to before dispatch: the compiled
    batch of a fixed-batch artifact, else the next power-of-two bucket,
    rounded up to a multiple of the device count (``--mesh`` splits it into
    equal chunks)."""
    if compiled_batch is not None:
        return compiled_batch
    target = _pow2_bucket(n)
    return -(-target // n_devices) * n_devices


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="serve an exported artifact over HTTP")
    p.add_argument("artifact", help="artifact file from cli.export "
                                    "(sibling .weights.npz required)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks an ephemeral port (printed on startup)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the card)")
    p.add_argument("--mesh", action="store_true",
                   help="split request batches over all local cards (weights on each, "
                        "one equal chunk per card)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup capture (first request pays it)")
    p.add_argument("--batch-window", type=float, default=0.0, metavar="MS",
                   help="dynamic batching: coalesce concurrent requests into one "
                        "device batch, dispatching when the compiled batch fills or "
                        "MS milliseconds after the first queued request (0 = off)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="coalescing cap for batch-POLYMORPHIC artifacts under "
                        "--batch-window (fixed-batch artifacts cap at their "
                        "compiled batch)")
    return p


class _Graph:
    """One captured padded batch: the graph and its static buffers."""

    def __init__(self, graph, frames, coords, maxvals):
        self.graph, self.frames, self.coords, self.maxvals = graph, frames, coords, maxvals


class _Servable:
    """The loaded artifact + its request contract, shared by all handler
    threads."""

    def __init__(self, artifact_path: str, *, device=None, warmup: bool = True,
                 mesh: bool = False):
        from dahpe_tpu_torch import serving
        from dahpe_tpu_torch.quant import to_torch

        self.device = resolve_device(device)
        devices = [self.device]
        if mesh:  # every local device of the serving device's type
            devices = [d for d in create_mesh() if d.type == self.device.type] or devices
        if self.device.type == "cuda":
            # deterministic cuDNN: otherwise some float32 convolution
            # algorithms sum in a varying order, so two answers to one
            # request differ in the last bits (measured on the H100) and a
            # graph replay cannot be held to eager execution
            torch.backends.cudnn.deterministic = True
        # one copy of the program a device (an exported program names its
        # device), the batch split over them and gathered on the first
        self.mesh = serving.make_mesh_predict(
            [serving.load_predict_file(artifact_path, device=d) for d in devices], devices)
        self.devices, self.predict = self.mesh.devices, self.mesh.predicts[0]
        self.weights = to_torch(serving.load_artifact_weights(artifact_path + ".weights.npz"),
                                self.device)
        meta = self.predict.meta
        self.kind = meta["kind"]
        self.batch = meta["batch"]  # None: polymorphic
        self.frame_shape = tuple(meta["frame_shape"])  # (H, W, 3)
        self.dtype = np.dtype(meta["dtype"])
        if self.batch is not None and len(self.devices) > 1:
            raise SystemExit(f"--mesh over {len(self.devices)} cards needs a batch-polymorphic "
                             f"artifact: this one runs batch {self.batch} only")
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._graphs: dict[int, list[_Graph]] = {}
        self._pools: dict[torch.device, tuple] = {}
        self.requests = 0   # /predict calls answered 200
        self.batches = 0    # device dispatches — ≤ requests under batching
        self.rows = 0       # live rows of those dispatches
        self.dispatch_s = 0.0  # host seconds in run_arrays, lock wait included
        self.queue_wait_s = 0.0  # batched requests: enqueue to dispatch start
        self.queue_wait_max_s = 0.0
        if warmup and self.batch is not None:
            with self._lock:
                self._execute(np.zeros((self.batch,) + self.frame_shape, self.dtype))

    def info(self) -> dict:
        return {
            "status": "ok",
            "kind": self.kind,
            "batch": self.batch,  # null = batch-polymorphic
            "frame_shape": list(self.frame_shape),
            "dtype": str(self.dtype),
            "devices": [str(d) for d in self.devices],
            "graphs": sorted(self._graphs),
            "requests": self.requests,
            "batches": self.batches,
            "rows": self.rows,
            "dispatch_s": self.dispatch_s,
            "queue_wait_s": self.queue_wait_s,
            "queue_wait_max_s": self.queue_wait_max_s,
        }

    def validate(self, frames: np.ndarray) -> None:
        """Request-contract errors raised OUTSIDE the device path, so the
        batcher never sees a malformed row."""
        if frames.ndim != 4 or frames.shape[1:] != self.frame_shape:
            raise ValueError(f"expected (B, {', '.join(map(str, self.frame_shape))}) "
                             f"frames, got {frames.shape}")
        if frames.dtype != self.dtype:
            raise ValueError(f"expected dtype {self.dtype}, got {frames.dtype}")
        if self.batch is not None and frames.shape[0] > self.batch:
            raise OverflowError(f"request batch {frames.shape[0]} > compiled batch "
                                f"{self.batch} (export batch-polymorphic for unbounded "
                                "requests)")

    def _capture(self, batch: int) -> list[_Graph]:
        """Capture the artifact at ``batch`` rows (``batch / n`` on each of
        the ``n`` cards) into one CUDA graph per card, each after one eager
        warm-up call on a side stream (cuDNN and cuBLAS pick their
        algorithms and workspaces outside the capture)."""
        rows, graphs = batch // len(self.devices), []
        for device, predict, weights in zip(self.devices, self.mesh.predicts,
                                            self.mesh.weights_on(self.weights)):
            with torch.cuda.device(device):
                frames = torch.zeros((rows,) + self.frame_shape, dtype=predict.dtype,
                                     device=device)
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    predict(weights, frames)
                torch.cuda.current_stream(device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                # one pool a card: a pool belongs to the device it was made
                # on; and the capture runs on this card's side stream, since
                # torch's default capture stream lives on the card that was
                # current when the first graph was made
                with torch.cuda.graph(graph, stream=side, pool=self._pools.setdefault(
                        device, torch.cuda.graph_pool_handle())):
                    coords, maxvals = predict(weights, frames)
                graphs.append(_Graph(graph, frames, coords, maxvals))
        self._graphs[batch] = graphs
        return graphs

    def _execute(self, frames: np.ndarray):
        """Run padded ``frames`` (under the dispatch lock): eagerly on the
        CPU, as the CUDA graph of their batch on the card. Returns numpy
        ``(coords, maxvals)``."""
        if self.device.type != "cuda":
            coords, maxvals = self.mesh(self.weights, torch.from_numpy(frames))
            return coords.numpy(), maxvals.float().numpy()
        graphs = self._graphs.get(frames.shape[0]) or self._capture(frames.shape[0])
        for g, chunk in zip(graphs, self.mesh.split(frames)):
            with torch.cuda.device(g.frames.device):
                g.frames.copy_(torch.from_numpy(chunk))
                g.graph.replay()  # the cards run their chunks side by side
        # gathered on the first card and copied out before the lock is
        # released: the next replay of a graph of the same pool may reuse
        # this memory
        coords, maxvals = self.mesh.gather([(g.coords, g.maxvals) for g in graphs])
        return coords.cpu().numpy(), maxvals.cpu().float().numpy()

    def run_arrays(self, frames: np.ndarray):
        """One device dispatch: pad to the compiled batch (fixed-batch
        artifacts) or the next power-of-two bucket (polymorphic ones; rows
        are per-sample independent, so padding never changes live rows),
        predict, return the live rows as numpy ``(coords (n, K, 2), maxvals
        (n, K))``."""
        t0 = time.perf_counter()
        n = frames.shape[0]
        target = _pad_target(n, self.batch, len(self.devices))
        if n < target:
            frames = np.concatenate(
                [frames, np.zeros((target - n,) + self.frame_shape, self.dtype)])
        with self._lock:
            try:
                coords, maxvals = self._execute(frames)
            except Exception as e:
                raise DispatchError(f"{type(e).__name__}: {e}") from e
            self.batches += 1
            self.rows += n
            self.dispatch_s += time.perf_counter() - t0
        return coords[:n], maxvals[:n, :, 0]

    def count_request(self) -> None:
        with self._count_lock:
            self.requests += 1

    def count_queue_waits(self, waits: list[float]) -> None:
        with self._count_lock:
            self.queue_wait_s += sum(waits)
            self.queue_wait_max_s = max(self.queue_wait_max_s, *waits)

    def run(self, frames: np.ndarray) -> dict:
        self.validate(frames)
        coords, maxvals = self.run_arrays(frames)
        self.count_request()
        return {"coords": coords.tolist(), "maxvals": maxvals.tolist()}


class _Batcher:
    """Dynamic batching: handler threads `submit` their frames and block; one
    collector thread dispatches a coalesced batch when `cap` rows are queued
    or `window` seconds have passed since the first queued request, then
    scatters the result rows back. Requests never split across dispatches."""

    def __init__(self, servable: _Servable, window_s: float, max_batch: int = 64):
        self.servable = servable
        self.window = window_s
        self.cap = servable.batch if servable.batch is not None else max_batch
        self._queue: list[dict] = []
        self._cv = threading.Condition()
        threading.Thread(target=self._collect, daemon=True).start()

    def submit(self, frames: np.ndarray) -> dict:
        item = {"frames": frames, "done": threading.Event(), "t": time.monotonic()}
        with self._cv:
            self._queue.append(item)
            self._cv.notify_all()
        item["done"].wait()
        if "error" in item:
            raise item["error"]
        self.servable.count_request()
        return {"coords": item["coords"].tolist(), "maxvals": item["maxvals"].tolist()}

    def _queued_rows(self) -> int:
        return sum(i["frames"].shape[0] for i in self._queue)

    def _collect(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                # the window runs from the HEAD request's enqueue time, so a
                # request never waits more than ~window even when it arrived
                # mid-dispatch
                deadline = self._queue[0]["t"] + self.window
                while self._queued_rows() < self.cap:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                # always take at least the head: a polymorphic artifact runs
                # any batch, so a request above the cap dispatches solo
                take, rows = [], 0
                while self._queue and (
                    not take or rows + self._queue[0]["frames"].shape[0] <= self.cap
                ):
                    item = self._queue.pop(0)
                    take.append(item)
                    rows += item["frames"].shape[0]
            now = time.monotonic()
            self.servable.count_queue_waits([now - i["t"] for i in take])
            try:
                coords, maxvals = self.servable.run_arrays(
                    np.concatenate([i["frames"] for i in take]))
                off = 0
                for item in take:
                    n = item["frames"].shape[0]
                    item["coords"] = coords[off:off + n]
                    item["maxvals"] = maxvals[off:off + n]
                    off += n
            except Exception as e:  # a device failure reaches every waiter
                err = e if isinstance(e, DispatchError) else DispatchError(
                    f"{type(e).__name__}: {e}")
                for item in take:
                    item["error"] = err
            finally:
                for item in take:
                    item["done"].set()


def _make_handler(servable: _Servable, batcher: _Batcher | None = None):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, servable.info())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                frames = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                if batcher is not None:
                    servable.validate(frames)
                    out = batcher.submit(frames)
                else:
                    out = servable.run(frames)
                self._reply(200, out)
            except OverflowError as e:
                self._reply(413, {"error": str(e)})
            except DispatchError as e:  # server fault, NOT the client's
                self._reply(500, {"error": str(e)})
            except Exception as e:  # malformed body/shape/dtype
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # route access logs to stdout
            print(f"{self.address_string()} {fmt % args}")

        # a stalled client read must not pin a (joined-on-close) handler
        # thread forever; the socket errors out and the thread exits
        timeout = 120

    return Handler


class _DrainingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``server_close`` drains: handler threads
    are non-daemon, so close joins every in-flight request before the
    process exits — a request is never cut mid-dispatch."""

    daemon_threads = False  # block_on_close (default True) then joins
    # the listen backlog: socketserver's default of 5 resets the connections
    # of a burst of concurrent clients, the load --batch-window coalesces
    request_queue_size = 128


def create_server(args) -> ThreadingHTTPServer:
    servable = _Servable(args.artifact, device=args.device, warmup=not args.no_warmup,
                         mesh=args.mesh)
    batcher = (_Batcher(servable, args.batch_window / 1e3, args.max_batch)
               if args.batch_window > 0 else None)
    server = _DrainingHTTPServer((args.host, args.port), _make_handler(servable, batcher))
    server.servable = servable
    return server


def main(args):
    import signal

    server = create_server(args)
    # container orchestrators stop with SIGTERM: finish in-flight requests,
    # stop accepting, exit 0 (same path as Ctrl-C). shutdown() must run off
    # the serve_forever thread, hence the helper thread.
    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=server.shutdown).start())
    host, port = server.server_address[:2]
    info = server.servable.info()
    b = info["batch"] if info["batch"] is not None else "polymorphic"
    batching = f", dynamic batching {args.batch_window:g} ms" if args.batch_window > 0 else ""
    print(f"serving {args.artifact} ({info['kind']}, batch {b}, {info['dtype']} "
          f"{tuple(info['frame_shape'])}) on http://{host}:{port} "
          f"[{', '.join(info['devices'])}{batching}]", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    print(f"drained: {server.servable.requests} requests in "
          f"{server.servable.batches} batches", flush=True)


if __name__ == "__main__":
    main(build_serve_parser().parse_args())
