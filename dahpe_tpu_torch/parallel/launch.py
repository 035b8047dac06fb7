"""Start the ranks of a data-parallel job from one process.

:func:`run_ranks` runs ``fn`` in ``world`` processes on this host, each
one rank of a process group brought up through the ``DAHPE_*`` contract
(:mod:`dahpe_tpu_torch.parallel.distributed`) on a free loopback port,
and returns rank 0's return value. The processes are spawned, never
forked: the CUDA runtime refuses a forked child once it is up, and each
rank loads the kernels again from ``build/kernels/``.

Nothing falls back. A rank that raises makes :func:`run_ranks` raise with
the traceback of the rank that raised first; a rank killed by a signal,
a launch that outlives its timeout, or too few cards for the backend
(NCCL needs one card a rank; ``DAHPE_DIST_BACKEND=gloo`` lets ranks share
one) all raise too.
No rank outlives the call on any exit path.
"""

from __future__ import annotations

import os
import shutil
import socket
import tempfile
import time
import traceback

import torch

from dahpe_tpu_torch.parallel import distributed

# seconds a whole launch may take by default: an acceptance run of 4000 +
# 3000 iterations over gloo ranks sharing one card takes most of an hour
LAUNCH_TIMEOUT = 6 * 3600.0


def free_port() -> int:
    """A TCP port free on the loopback when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, device: str, kwargs: dict,
               outdir: str) -> None:
    """One spawned rank: its rendezvous in the environment, bring-up,
    ``fn(**kwargs)``, rank 0's return value saved to ``outdir``. A rank
    that raises first leaves its traceback there with the (system-wide)
    monotonic time, so the caller can tell the first failure from the
    ranks it broke."""
    os.environ.update(DAHPE_COORDINATOR=f"127.0.0.1:{port}", DAHPE_NUM_PROCESSES=str(world),
                      DAHPE_PROCESS_ID=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        distributed.robust_distributed_initialize(device, verbose=False)
        out = fn(**kwargs)
        if rank == 0:
            torch.save(out, os.path.join(outdir, "rank0.pt"))
    except BaseException:
        with open(os.path.join(outdir, f"error{rank}.txt"), "w") as fh:
            fh.write(f"{time.monotonic()}\n{traceback.format_exc()}")
        raise
    finally:
        distributed.shutdown()


def _first_error(outdir: str) -> tuple[int, str] | None:
    """The rank that raised first and its traceback, if any rank raised."""
    found = []
    for name in os.listdir(outdir):
        if name.startswith("error"):
            with open(os.path.join(outdir, name)) as fh:
                when, text = fh.read().split("\n", 1)
            found.append((float(when), int(name[5:-4]), text))
    return min(found)[1:] if found else None


def run_ranks(fn, world: int, *, device="cuda", kwargs: dict | None = None,
              timeout: float | None = None):
    """``fn(**kwargs)`` on ``world`` spawned ranks of one process group on
    this host (the backend of ``device``: NCCL on a card unless
    ``DAHPE_DIST_BACKEND`` says otherwise, gloo on the CPU); returns rank
    0's return value. ``fn`` and ``kwargs`` must pickle (``fn`` a
    module-level function). Raises without starting a rank when a cuda run
    has too few cards for its backend, and raises when a rank fails or the
    launch outlives ``timeout`` seconds (default :data:`LAUNCH_TIMEOUT`)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    if world < 1:
        raise ValueError(f"run_ranks: world {world}")
    # the check each rank makes after bring-up, made before any rank starts
    distributed.rank_device(device, 0, world)
    timeout = LAUNCH_TIMEOUT if timeout is None else timeout
    outdir = tempfile.mkdtemp(prefix="dahpe_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, free_port(), str(device), kwargs or {}, outdir),
            nprocs=world, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + timeout
            # join raises once a rank has failed, after terminating the others
            while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"run_ranks: {world} ranks still running after "
                                       f"{timeout:.0f} s")
        except ProcessException as err:
            first = _first_error(outdir)
            if first is None:  # killed by a signal: no traceback
                raise
            raise RuntimeError(f"run_ranks: rank {first[0]} of {world} raised:\n"
                               f"{first[1]}") from err
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(os.path.join(outdir, "rank0.pt"), weights_only=False)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
