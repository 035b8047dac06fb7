"""Sustained soak: many epochs through the real training CLI, with a stop at
an epoch boundary and a ``--resume`` continuation.

Port of ``dahpe_tpu/experiments/soak.py``. It drives ``python -m
dahpe_tpu_torch.cli.train`` as a user would: subprocesses, the
``--device-store --decoded-cache`` input mode, per-epoch checkpoints, on the
synthetic shifted domains (``data/synthetic.py``) at the reference schedule
shape (``-i`` iterations × ``--epochs``). The run is split at an epoch
boundary into two processes; the second starts from ``--resume`` and must
pick up the epoch index, the best-accuracy watermark and the sampling
generators' states (the sidecar of ``utils/checkpoint.save_aux``).

Asserted at the end:
- both processes completed every scheduled epoch;
- the per-iteration time stayed stable (the last quarter of the displayed
  DA iteration times against the second quarter);
- the resumed process reports continuing with its stream states;
- the best target PCK after the stop is at least the best before it.

    python -m dahpe_tpu_torch.experiments.soak /tmp/soak [--epochs 20 ...]
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

# the training CLI's argv prefix; a caller may put a wrapper in its place
TRAIN_CLI = (sys.executable, "-m", "dahpe_tpu_torch.cli.train")


def _env() -> dict:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_cli(command, args_list, log_path):
    t0 = time.time()
    with open(log_path, "w") as f:
        proc = subprocess.run([*command, *args_list], stdout=f, stderr=subprocess.STDOUT,
                              env=_env())
    return proc.returncode, time.time() - t0


def _parse_metrics(log_text):
    """Per-epoch target PCK, best-PCK watermarks and the displayed DA
    iteration times of a training CLI log.

    The epoch summary lines carry no epoch number, so PCKs are indexed by
    order of appearance. Only DA display lines (those with the target
    disparity meter) give times: the pretrain phase prints the same
    ``Time`` meter at about a third of the cost, and mixing the phases into
    the stability quartiles would let an epoch split fake or hide a drift."""
    tgt = [float(m.group(2)) for m in re.finditer(
        r"Source: *([\d.-]+) Target: *([\d.-]+) Target\(best\): *([\d.-]+)", log_text)]
    best = [float(m.group(1)) for m in re.finditer(r"Target\(best\): *([\d.-]+)", log_text)]
    times = [float(m.group(1)) for m in re.finditer(
        r"Time +([\d.]+) +\([^\n]*Loss \(t, false\)", log_text)]
    return tgt, best, times


def run_soak(workdir: str, *, arch: str = "resnet101", image_size: int = 256,
             heatmap_size: int = 64, batch: int = 32, iters: int = 500, epochs_total: int = 20,
             stop_after: int = 8, pretrain_epochs: int = 2, shift_args: tuple = (),
             bf16: bool = True, seed: int = 1, device: str = "cuda", command=TRAIN_CLI,
             verbose: bool = True) -> dict:
    """The two-process soak in ``workdir``; returns its summary. ``command``
    is the training CLI's argv prefix."""
    os.makedirs(workdir, exist_ok=True)
    log_dir = os.path.join(workdir, "logs")
    base = [
        workdir,  # target_root (unused by the procedural datasets)
        "-s", "SyntheticHandsSource", "-t", "SyntheticHandsTarget",
        "-a", arch, "-b", str(batch), "-i", str(iters),
        "--image-size", str(image_size), "--heatmap-size", str(heatmap_size),
        "--pretrain-epochs", str(pretrain_epochs),
        "--log", log_dir, "--print-freq", "100", "--seed", str(seed),
        "--device-store", "--decoded-cache", os.path.join(workdir, "cache"),
        "--rotation", "30", "--device", device,
    ] + list(shift_args) + (["--bf16"] if bf16 else [])

    def log(msg):
        if verbose:
            print(msg, flush=True)

    log(f"soak phase 1: epochs 0..{stop_after - 1} ({arch}@{image_size}, b{batch}, "
        f"{iters} iters/epoch)")
    rc1, t1 = _run_cli(command, base + ["--epochs", str(stop_after)],
                       os.path.join(workdir, "phase1.log"))
    assert rc1 == 0, f"phase 1 failed (rc={rc1}); see {workdir}/phase1.log"
    ckpt = os.path.join(log_dir, "checkpoints", str(stop_after - 1))
    assert os.path.isdir(ckpt), f"missing epoch checkpoint {ckpt}"
    assert os.path.exists(ckpt + "_aux.npz"), "missing stream-state sidecar"

    log(f"soak phase 2: --resume from epoch {stop_after - 1} to {epochs_total}")
    rc2, t2 = _run_cli(command, base + ["--epochs", str(epochs_total), "--resume", ckpt],
                       os.path.join(workdir, "phase2.log"))
    assert rc2 == 0, f"phase 2 failed (rc={rc2}); see {workdir}/phase2.log"

    text1 = open(os.path.join(workdir, "phase1.log")).read()
    text2 = open(os.path.join(workdir, "phase2.log")).read()
    tgt1, best1, times1 = _parse_metrics(text1)
    tgt2, best2, times2 = _parse_metrics(text2)
    assert len(tgt1) == stop_after, (len(tgt1), stop_after)
    assert len(tgt2) == epochs_total - stop_after, (len(tgt2),)
    assert "(with stream keys)" in text2, "resume did not load the sidecar"
    assert f"Epoch: [{stop_after}]" in text2, "resume rewound the epoch index"
    assert best2[0] >= best1[-1] - 1e-9, (best1[-1], best2[0])  # watermark held

    # stability: the median displayed iteration time of the last quarter
    # against the second quarter (the first holds the warm-up)
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else float("nan")

    all_times = times1 + times2
    q = max(1, len(all_times) // 4)
    early, late = med(all_times[q:2 * q]), med(all_times[-q:])
    result = {
        "epochs": epochs_total,
        "stop_after": stop_after,
        "target_pck": tgt1 + tgt2,
        "best_final": best2[-1] if best2 else None,
        "best_at_stop": best1[-1] if best1 else None,
        "iter_time_early_s": early,
        "iter_time_late_s": late,
        "wall_phase1_s": t1,
        "wall_phase2_s": t2,
    }
    log(f"soak done: target PCK per epoch {result['target_pck']}")
    log(f"iter time early/late: {early:.3f}/{late:.3f} s; "
        f"best {result['best_at_stop']} -> {result['best_final']}")
    assert late < early * 1.5 + 0.05, f"iteration time drifted: {early:.3f} -> {late:.3f} s"
    return result


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("workdir")
    p.add_argument("--arch", default="resnet101")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--stop-after", type=int, default=8)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--heatmap-size", type=int, default=64)
    p.add_argument("--pretrain-epochs", type=int, default=2)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    run_soak(a.workdir, arch=a.arch, epochs_total=a.epochs, stop_after=a.stop_after,
             iters=a.iters, batch=a.batch, image_size=a.image_size,
             heatmap_size=a.heatmap_size, pretrain_epochs=a.pretrain_epochs, device=a.device)
