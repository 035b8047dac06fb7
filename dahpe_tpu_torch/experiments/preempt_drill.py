"""Preemption drill: SIGTERM a DA run mid-epoch, resume from
``checkpoints/latest``, finish the schedule.

Port of ``dahpe_tpu/experiments/preempt_drill.py``. The training CLI's
graceful stop (``cli/train.py``: SIGTERM finishes the in-flight iteration,
saves ``latest`` with the stream-state sidecar and exits 0) is driven
through the real CLI on the ``--device-store`` fused iteration: a SIGTERM
lands in the middle of an epoch, and a ``--resume latest`` must pick up at
the exact iteration with the sampling generators' states and complete the
schedule.

Asserted:
- the preempted process exits 0 with ``checkpoints/latest`` at a
  mid-epoch step and its sidecar;
- the resumed process prints ``at epoch E iteration I (with stream keys)``
  with I the saved step modulo the iterations an epoch;
- every scheduled epoch's checkpoint exists at the end.

    python -m dahpe_tpu_torch.experiments.preempt_drill /tmp/drill
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import time

import numpy as np

from dahpe_tpu_torch.experiments.soak import TRAIN_CLI, _env, _parse_metrics


def _spawn_cli(command, args_list, log_path):
    with open(log_path, "w") as f:  # Popen dups the descriptor
        return subprocess.Popen([*command, *args_list], stdout=f, stderr=subprocess.STDOUT,
                                env=_env())


def run_drill(workdir: str, *, arch: str = "resnet101", image_size: int = 256,
              heatmap_size: int = 64, batch: int = 32, iters: int = 100, epochs: int = 2,
              save_every: int = 25, signal_after_iter: int = 40, print_freq: int = 10,
              bf16: bool = True, seed: int = 1, device: str = "cuda", command=TRAIN_CLI,
              timeout_s: float = 1800.0, poll_s: float = 5.0, verbose: bool = True) -> dict:
    """The drill in ``workdir``; returns its record. ``command`` is the
    training CLI's argv prefix; the log is polled every ``poll_s`` seconds
    until a display line shows ``signal_after_iter``."""
    os.makedirs(workdir, exist_ok=True)
    log_dir = os.path.join(workdir, "logs")
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    phase1_log = os.path.join(workdir, "phase1.log")
    base = [
        workdir,
        "-s", "SyntheticHandsSource", "-t", "SyntheticHandsTarget",
        "-a", arch, "-b", str(batch), "-i", str(iters),
        "--image-size", str(image_size), "--heatmap-size", str(heatmap_size),
        "--pretrain-epochs", "0", "--epochs", str(epochs),
        "--log", log_dir, "--print-freq", str(print_freq), "--seed", str(seed),
        "--device-store", "--decoded-cache", os.path.join(workdir, "cache"),
        "--rotation", "30", "--save-every", str(save_every), "--device", device,
    ] + (["--bf16"] if bf16 else [])

    def log(msg):
        if verbose:
            print(msg, flush=True)

    log(f"drill phase 1: {arch}@{image_size} b{batch}, {iters} iters/epoch x {epochs}; "
        f"SIGTERM after iteration ~{signal_after_iter}")
    t_start = time.time()
    proc = _spawn_cli(command, base, phase1_log)
    try:
        # wait for the DA loop to pass `signal_after_iter` (displays land
        # every --print-freq iterations)
        deadline = time.time() + timeout_s
        seen = -1
        while time.time() < deadline:
            text = open(phase1_log).read() if os.path.exists(phase1_log) else ""
            marks = [int(m.group(1)) for m in re.finditer(r"Epoch: \[0\]\[ *(\d+)/", text)]
            if marks and marks[-1] != seen:
                seen = marks[-1]
                log(f"  phase 1 at iteration {seen}")
            if seen >= signal_after_iter:
                break
            if proc.poll() is not None:
                raise AssertionError(f"phase 1 exited early (rc={proc.returncode}); "
                                     f"see {phase1_log}")
            time.sleep(poll_s)
        else:
            raise AssertionError("phase 1 never reached the signal point")
        log("  sending SIGTERM")
        t_sig = time.time()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=600)
        drain_s = time.time() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    phase1_s = time.time() - t_start
    assert rc == 0, f"preempted process exited {rc}, want 0; see {phase1_log}"

    text1 = open(phase1_log).read()
    assert "saving checkpoints/latest, then exiting cleanly" in text1
    m = re.search(r"stop requested at step (\d+) \(epoch (\d+) iteration (\d+)\)", text1)
    assert m, "no drain record in the phase-1 log"
    stop_step, stop_epoch, stop_iter = map(int, m.groups())
    assert stop_step % iters != 0, ("the drill landed on an epoch boundary; raise "
                                     "signal_after_iter so the evidence stays mid-epoch")
    latest = os.path.join(ckpt_dir, "latest")
    assert os.path.isdir(latest), "checkpoints/latest missing"
    aux = np.load(latest + "_aux.npz")
    assert {"best_acc", "key_s", "key_t"} <= set(aux.files)
    log(f"  preempted at step {stop_step} (epoch {stop_epoch} iteration {stop_iter}), "
        f"drain {drain_s:.1f}s, exit 0")

    phase2_log = os.path.join(workdir, "phase2.log")
    log(f"drill phase 2: --resume {latest}")
    t0 = time.time()
    proc = _spawn_cli(command, base + ["--resume", latest], phase2_log)
    try:
        rc2 = proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    phase2_s = time.time() - t0
    assert rc2 == 0, f"resumed process exited {rc2}; see {phase2_log}"
    text2 = open(phase2_log).read()
    want = f"at epoch {stop_epoch} iteration {stop_step % iters} (with stream keys)"
    assert want in text2, f"resume line missing {want!r}"
    for e in range(epochs):
        assert os.path.isdir(os.path.join(ckpt_dir, str(e))), \
            f"epoch checkpoint {e} missing after resume"

    _, _, times1 = _parse_metrics(text1)
    _, _, times2 = _parse_metrics(text2)
    result = {
        "stop_step": stop_step,
        "stop_epoch": stop_epoch,
        "stop_iter": stop_iter,
        "drain_s": round(drain_s, 1),
        "resume_iter": stop_step % iters,
        "epochs_completed": epochs,
        "phase1_s": phase1_s,
        "phase2_s": phase2_s,
        "iter_times_p1": times1[-3:],
        "iter_times_p2": times2[-3:],
    }
    log(f"drill OK: {result}")
    return result


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("workdir")
    p.add_argument("--arch", default="resnet101")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--heatmap-size", type=int, default=64)
    p.add_argument("--save-every", type=int, default=25)
    p.add_argument("--signal-after-iter", type=int, default=40)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    run_drill(a.workdir, arch=a.arch, iters=a.iters, epochs=a.epochs, batch=a.batch,
              image_size=a.image_size, heatmap_size=a.heatmap_size, save_every=a.save_every,
              signal_after_iter=a.signal_after_iter, device=a.device)
