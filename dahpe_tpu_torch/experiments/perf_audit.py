"""Stage-by-stage time of the device batch producer.

Port of ``dahpe_tpu/experiments/perf_audit.py``. The producer of the
``--device-store`` iteration (``DeviceDataStore.traced_batch_fn``: row
draw and gather, the rotation kernel, the crop-resize products, colour
jitter, blur, normalize, the Gaussian-target kernel) runs twice an
iteration, once per domain. Each PREFIX of it (stage 1, stages 1-2, ...) is
timed on the card: warm-up calls, one call captured as a CUDA graph, then
the median of ``repeats`` loops of ``iters`` replays timed with CUDA events.
The replays make the time the device's, as the JAX audit's jitted calls do:
eager calls would time the host's launch rate, since the producer's kernels
are small. The marginal cost of stage k is
``prefix(k) - prefix(k-1)``, measured with the stages before it, as the
iteration runs them. Every prefix draws its rows and augmentation from the
generator, as the producer does.

With ``dtype=torch.bfloat16`` the ``norm`` stage also casts the images to
the compute dtype, the cast a ``--bf16`` model's first convolution makes;
the stages before it are the float32 run's.

    python -m dahpe_tpu_torch.experiments.perf_audit [--batch 32] [--bf16]
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from dahpe_tpu_torch.core.heatmap import generate_target
from dahpe_tpu_torch.data import device_aug as da

STAGES = ("gather", "rotate", "crop", "jitter", "blur", "norm", "targets")


def make_prefix(upto: str, store, *, image_size: int = 256, heatmap_size: int = 64,
                sigma: float = 2.0, dtype=None):
    """The producer through stage ``upto``: ``(idx, params) -> (image-like,
    aux)`` on a :class:`~dahpe_tpu_torch.data.device_store.DeviceDataStore`,
    stage for stage ``train_batch_from`` (through ``targets`` it returns
    the batch's images and targets)."""
    if upto not in STAGES:
        raise ValueError(f"unknown stage {upto!r}; stages: {STAGES}")
    h, w, c = store.images.shape[1:]

    def run(idx, params):
        img = store.images.view(store.n, h * w * c).index_select(0, idx).view(-1, h, w, c)
        kp = store.kps.index_select(0, idx)
        if upto == "gather":
            return img, kp
        out = da._rotate_shears(img, params["angle"], params.get("slopes"))
        if upto == "rotate":
            return out, kp
        out = da._crop_resize_matmul(out, params["side"], params["offset"], image_size)
        kp, _ = da._warp_keypoints(kp, store.intr.index_select(0, idx), params, size=w,
                                   out_size=image_size)
        if upto == "crop":
            return out, kp
        out = da._color_jitter(out, params["factors"], params["order"])
        if upto == "jitter":
            return out, kp
        out = da._gaussian_blur(out, params["radius"])
        if upto == "blur":
            return out, kp
        consts = da._constants(out.device)
        out = ((out / 255.0 - consts["mean"]) / consts["std"]).permute(0, 2, 3, 1).contiguous()
        if dtype is not None:
            out = out.to(dtype)
        if upto == "norm":
            return out, kp
        target, _ = generate_target(kp, store.vis.index_select(0, idx),
                                    (heatmap_size, heatmap_size), (image_size, image_size),
                                    sigma=sigma)
        return out, target

    return run


def drawn(fn, store, batch: int, *, rotation: float = 180.0, scale_range=(0.6, 1.3)):
    """``generator -> fn(idx, params)`` with the producer's draws: ``batch``
    rows without replacement, then their augmentation parameters."""
    def call(generator):
        idx = torch.randperm(store.n, generator=generator, device=store.device)[:batch]
        params = da.draw_augment_params(generator, batch, size=store.raw_size,
                                        rotation=rotation, scale_range=scale_range)
        return fn(idx, params)

    return call


def timed_ms(call, generator, *, iters: int = 30, repeats: int = 9, warmup: int = 5) -> float:
    """Median over ``repeats`` loops of ``iters`` graph replays of the
    device time a call, from CUDA events around each loop: ``warmup`` eager
    calls on a side stream, then one call captured as a CUDA graph with
    ``generator`` registered, so every replay draws anew."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            call(generator)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        call(generator)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


class SeededFrames:
    """``n`` seeded uint8 frames of side ``size`` with keypoints inside them,
    in the store's ``fetch_raw`` protocol (the JAX audit's random store)."""

    num_keypoints = 21

    def __init__(self, n: int, size: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, size, size, 3), np.uint8)
        self.kps = rng.uniform(20, size - 20, (n, 21, 2)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def fetch_raw(self, i, rng, raw_size):
        return {"image_u8": self.images[i], "keypoint2d": self.kps[i],
                "visible": np.ones(21, np.float32), "intrinsic_matrix": np.eye(3, dtype=np.float32)}


def run_audit(store, *, batch: int = 32, image_size: int = 256, heatmap_size: int = 64,
              dtype=None, iters: int = 30, repeats: int = 9, seed: int = 0,
              verbose: bool = True) -> dict:
    """Each prefix's ms and each stage's marginal ms on ``store`` (on the
    card), and the whole producer's ms (``DeviceDataStore.traced_batch_fn``,
    its images cast to ``dtype`` when given) timed the same way."""
    cfg = dict(image_size=image_size, heatmap_size=heatmap_size)
    prefix, marginal, prev = {}, {}, 0.0
    for name in STAGES:
        ms = timed_ms(drawn(make_prefix(name, store, dtype=dtype, **cfg), store, batch),
                      store.generator(seed), iters=iters, repeats=repeats)
        prefix[name], marginal[name], prev = ms, ms - prev, ms
        if verbose:
            print(f"{name:10s} prefix {ms:8.3f} ms   marginal {marginal[name]:+8.3f} ms",
                  flush=True)
    whole = store.traced_batch_fn(batch, **cfg)

    def producer(generator):
        batch_out = whole(generator)
        return batch_out["image"].to(dtype) if dtype is not None else batch_out["image"]

    whole_ms = timed_ms(producer, store.generator(seed), iters=iters, repeats=repeats)
    if verbose:
        print(f"full producer ({batch} images): {whole_ms:.3f} ms -> x2 domains = "
              f"{2 * whole_ms:.3f} ms an iteration", flush=True)
    return {"prefix_ms": prefix, "stage_ms": marginal, "stages_sum_ms": prev,
            "producer_ms": whole_ms}


def main(batch: int = 32, raw: int = 288, out_size: int = 256, n_store: int = 256,
         bf16: bool = False) -> dict:
    from dahpe_tpu_torch.data.device_store import DeviceDataStore

    if not torch.cuda.is_available():
        raise SystemExit("perf_audit times the card: no CUDA device")
    store = DeviceDataStore(SeededFrames(n_store, raw), device="cuda", raw_size=raw,
                            verbose=False)
    print(f"# perf audit: {torch.cuda.get_device_name(0)}, batch {batch}, raw {raw}, "
          f"out {out_size}, store {n_store}, {'bf16' if bf16 else 'float32'}", flush=True)
    return run_audit(store, batch=batch, image_size=out_size,
                     dtype=torch.bfloat16 if bf16 else None)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--raw", type=int, default=288)
    p.add_argument("--out", type=int, default=256)
    p.add_argument("--bf16", action="store_true")
    a = p.parse_args()
    main(a.batch, a.raw, a.out, bf16=a.bf16)
