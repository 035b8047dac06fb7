"""Driver of the HTTP serving cells: the port's server,
``python -m dahpe_tpu_torch.cli.serve <artifact> --batch-window MS
--max-batch N``, under closed-loop clients.

Set-up writes the seeded model's serving weights beside the artifact that
``python -m dahpe_tpu_torch.cli.export --uint8-input`` made from a
checkpoint of it (the artifact holds the program, not its weights, so it is
exported once per checkout into ``build/portbench_cache/serve/`` and reused),
starts the server on a free loopback port (through
``portbench/serve_shim.py``, which only adds a profiler switch), sends one
request of each padded batch the traffic makes so every CUDA graph is
captured, and runs the clients for ``warmup_s``. The window runs
``clients`` client threads, each sending ``frames_per_request`` seeded
frames and waiting for the keypoints before it sends again, until the time
is out; it closes at the last reply. A traced run profiles the server for
``trace_s`` seconds of the same load before the window.

After the window the server is stopped and the plain reference
(:mod:`portbench.reference.serve`) computes the heatmaps of a seeded sample
of the answered requests: each served keypoint's reference value is held to
the reference's best (``argmax_gap``) and the served confidence to that
value (``maxval_gap``).
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection

import numpy as np
import torch

from portbench import inputs
from portbench.reference.follow import state_shapes
from portbench.reference.serve import ServeReference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "build", "portbench_cache", "serve")
SHIM = os.path.join(ROOT, "portbench", "serve_shim.py")
ARCHS = {("Bottleneck", (3, 4, 6, 3)): "resnet50", ("Bottleneck", (3, 4, 23, 3)): "resnet101",
         ("Bottleneck", (3, 8, 36, 3)): "resnet152"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Client:
    """The endpoint's wire format (``dahpe_tpu_torch/client.py``): an
    ``.npy`` body of frames to ``POST /predict``, JSON keypoints back; one
    kept-alive connection."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.conn = HTTPConnection(host, port, timeout=timeout)

    def predict(self, frames: np.ndarray):
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(frames))
        self.conn.request("POST", "/predict", body=buf.getvalue())
        resp = self.conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return resp.status, None, None
        out = json.loads(body)
        return 200, np.asarray(out["coords"], np.float32), np.asarray(out["maxvals"], np.float32)

    def health(self) -> dict:
        self.conn.request("GET", "/healthz")
        return json.loads(self.conn.getresponse().read())

    def close(self) -> None:
        self.conn.close()


def server_command(artifact: str, summary: str, traffic: dict, device: str) -> list[str]:
    return [sys.executable, SHIM, summary, str(traffic["trace_prime_s"]), "--", artifact,
            "--host", "127.0.0.1", "--port", "0", "--device", device,
            "--batch-window", str(traffic["batch_window_ms"]),
            "--max-batch", str(traffic["max_batch"])]


def artifact_for(config: dict, weights: dict, device: str, tmp: str) -> str:
    """The checkout's exported program for ``config``, made by ``cli.export``
    from a checkpoint of ``weights`` on its first use."""
    arch = ARCHS[(config["block"], tuple(config["layers"]))]
    dev = torch.device(device).type
    path = os.path.join(CACHE, f"{arch}_{config['image_size']}_{config['heatmap_size']}_u8_{dev}.pt2")
    if os.path.exists(path):
        return path
    os.makedirs(CACHE, exist_ok=True)
    pth = os.path.join(tmp, "model.pth")
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    part = f"{path}.part{os.getpid()}"
    subprocess.run([sys.executable, "-m", "dahpe_tpu_torch.cli.export", pth, "-o", part,
                    "-a", arch, "--image-size", str(config["image_size"]),
                    "--heatmap-size", str(config["heatmap_size"]), "--uint8-input",
                    "--device", device], check=True, cwd=ROOT, stdout=sys.stderr)
    os.remove(part + ".weights.npz")
    os.remove(pth)
    os.replace(part, path)
    return path


def start_server(cmd: list[str], logfile: str, timeout: float):
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=open(logfile, "w"), stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(logfile) as fh:
            for line in fh:
                if " on http://" in line:
                    host, port = line.split(" on http://", 1)[1].split()[0].rsplit(":", 1)
                    return proc, host, int(port)
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    stop_server(proc)
    with open(logfile) as fh:
        raise RuntimeError("the server did not start:\n" + fh.read()[-4000:])


def stop_server(proc) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def closed_loop(address, pool: np.ndarray, traffic: dict, seed: int, seconds: float,
                tag: str) -> dict:
    """``clients`` closed-loop clients for ``seconds``; every request's
    client, frames, send and reply times, status and answer."""
    n, per = int(traffic["clients"]), int(traffic["frames_per_request"])
    records, lock = [], threading.Lock()
    deadline = time.perf_counter() + seconds

    def client(c: int) -> None:
        rng = np.random.default_rng(inputs.sub_seed(seed, f"{tag}-client-{c}"))
        conn = Client(*address)
        try:
            while time.perf_counter() < deadline:
                idx = rng.choice(len(pool), per, replace=False)
                t0 = time.perf_counter()
                try:
                    status, coords, maxvals = conn.predict(pool[idx])
                except (OSError, ValueError) as e:
                    log(f"client {c}: {type(e).__name__}: {e}")
                    status, coords, maxvals = None, None, None
                    conn.close()
                    conn = Client(*address)
                with lock:
                    records.append((idx, t0, time.perf_counter(), status, coords, maxvals))
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    end = max((r[2] for r in records), default=time.perf_counter())
    return {"records": records, "seconds": end - t0}


def gpu_memory_used() -> int:
    """Bytes in use on the card (every process), by ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30).stdout
    return int(float(out.strip().splitlines()[0]) * 2**20)


def compare(ref: ServeReference, pool: np.ndarray, sample: list, scale: float,
            control: str | None = None, block: int = 64) -> dict:
    """``argmax_gap``: the widest gap by which the reference's heatmap at a
    served keypoint lies below its best; ``maxval_gap``: the widest gap
    between a served confidence and that reference value. With ``control``
    the reference in that precision takes the served answers' place."""
    idx = np.concatenate([s[0] for s in sample])
    coords = np.concatenate([s[1] for s in sample]) if control is None else None
    maxvals = np.concatenate([s[2] for s in sample]) if control is None else None
    arg_gap = val_gap = 0.0
    for a in range(0, len(idx), block):
        frames = torch.from_numpy(pool[idx[a:a + block]])
        y = ref.heatmaps(frames)  # (B, h, w, K)
        b, h, w, k = y.shape
        flat = y.reshape(b, h * w, k)
        best = flat.amax(dim=1)
        if control is None:
            xy = torch.from_numpy(coords[a:a + block] / scale).round().long().to(y.device)
            served_val = torch.from_numpy(maxvals[a:a + block]).to(y.device)
        else:
            yc = ref.heatmaps(frames, control=control).reshape(b, h * w, k)
            at = yc.argmax(dim=1)
            xy = torch.stack([at % w, at // w], dim=-1)
            served_val = yc.amax(dim=1)
        pos = (xy[..., 1] * w + xy[..., 0]).clamp(0, h * w - 1)
        value = flat.gather(1, pos[:, None, :])[:, 0]
        # the decode zeroes a keypoint whose peak is not above 0
        void = (served_val <= 0) & (best <= 0)
        arg_gap = max(arg_gap, float(torch.where(void, 0.0, best - value).max()))
        val_gap = max(val_gap, float(torch.where(void, 0.0, (served_val - value).abs()).max()))
    return {"argmax_gap": arg_gap, "maxval_gap": val_gap}


def run(*, config, traffic, seed, seconds, trace, device, stage) -> dict:
    from dahpe_tpu_torch import serving

    stage("imports")
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="portbench-serve-")
    proc = None
    try:
        weights = inputs.make_weights(state_shapes(config, device), seed, device)
        pool = inputs.make_frames(seed, "serve", int(traffic["frame_pool"]), config["image_size"],
                                  config["num_keypoints"], device)["images"].cpu().numpy()
        stage("weights")
        cached = artifact_for(config, weights, device, tmp)
        stage("export")
        artifact = os.path.join(tmp, "model.pt2")
        shutil.copyfile(cached, artifact)
        serving.save_variables_npz(artifact + ".weights.npz", weights)
        del weights
        if on_card:
            torch.cuda.empty_cache()
        stage("weights_file")
        summary = os.path.join(tmp, "trace.json")
        proc, host, port = start_server(server_command(artifact, summary, traffic, device),
                                        os.path.join(tmp, "server.log"),
                                        float(traffic["server_timeout_s"]))
        stage("server_start")
        warm = Client(host, port)
        for rows in traffic["warm_rows"]:  # one dispatch of each padded batch
            status, _, _ = warm.predict(pool[:rows])
            if status != 200:
                raise RuntimeError(f"warm-up request of {rows} frames answered {status}")
        closed_loop((host, port), pool, traffic, seed, float(traffic["warmup_s"]), "warmup")
        stage("warmup_and_capture")
        traced = None
        if trace:
            proc.send_signal(signal.SIGUSR1)
            closed_loop((host, port), pool, traffic, seed,
                        float(traffic["trace_prime_s"]) + float(traffic["trace_s"]), "trace")
            proc.send_signal(signal.SIGUSR2)
            deadline = time.monotonic() + 300
            while not os.path.exists(summary) and time.monotonic() < deadline:
                time.sleep(0.2)
            with open(summary) as fh:
                traced = json.load(fh)
        before = warm.health()
        win = closed_loop((host, port), pool, traffic, seed, seconds, "window")
        after = warm.health()
        warm.close()
        memory = gpu_memory_used() if on_card else 0
        stop_server(proc)
    finally:
        if proc is not None:
            stop_server(proc)
        shutil.rmtree(tmp, ignore_errors=True)

    records, per = win["records"], int(traffic["frames_per_request"])
    k = config["num_keypoints"]
    ok = [r[3] == 200 and r[4] is not None and r[4].shape == (per, k, 2) for r in records]
    good = [r for r, fine in zip(records, ok) if fine]
    failed = len(records) - len(good)
    latency = sorted(1e3 * (r[2] - r[1]) if fine else math.inf for r, fine in zip(records, ok))
    p95 = latency[max(0, math.ceil(0.95 * len(latency)) - 1)] if latency else math.inf
    frames = per * len(good)
    batches = after["batches"] - before["batches"]
    log(f"window: {len(records)} requests ({failed} failed), {frames} frames in "
        f"{win['seconds']:.4f} s, {batches} dispatches, latency ms median "
        f"{latency[len(latency) // 2]:.3f} p95 {p95:.3f}")
    end_to_end = {"serve_img_s": frames / win["seconds"],
                  "serve_p95_ms": p95 if math.isfinite(p95) else 1e3 * win["seconds"]}

    ref = ServeReference(config, seed, device)
    rng = np.random.default_rng(inputs.sub_seed(seed, "compared-requests"))
    pick = rng.choice(len(good), min(len(good), int(traffic["compared_requests"])), replace=False)
    sample = [(good[i][0], good[i][4], good[i][5]) for i in sorted(pick)]
    scale = config["image_size"] / config["heatmap_size"]
    read = compare(ref, pool, sample, scale) if sample else {
        "argmax_gap": math.inf, "maxval_gap": math.inf}
    log("readings: " + json.dumps(read))
    limits = traffic["limits"]
    window = {"frames": frames, "seconds": win["seconds"], "requests": len(records),
              "batches": batches}
    breakdown = None
    if traced is not None:
        breakdown = {"device_ops": sorted(traced["kinds_s"].items(), key=lambda kv: -kv[1])[:10],
                     "idle_gaps": [list(g) for g in traced["gaps"][:10]]}
        log(f"trace: {traced['kernels']} kernels in {traced['wall_s']:.4f} s, "
            f"busy {traced['busy_s']:.4f} s")
    return {"attempted": len(records), "failed": failed, "end_to_end": end_to_end,
            "context": {"config": config, "traffic": traffic, "window": window, "trace": traced,
                        "sample": [s[0] for s in sample]},
            "compared": {n: (read[n], limits[n]) for n in limits},
            "memory_peak_bytes": memory, "breakdown": breakdown,
            "busy_s": None if traced is None else traced["busy_s"],
            "window_s": None if traced is None else traced["wall_s"]}
