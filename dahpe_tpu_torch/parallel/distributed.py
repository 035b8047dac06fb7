"""Process-group bring-up for the ``--multihost`` path.

Port of ``dahpe_tpu/parallel/distributed.py``. One process drives one
device; ``torch.distributed`` joins the processes into one data-parallel
job. Bring-up is the step that talks to the network before any collective
exists, and a rendezvous can lose a race with a coordinator that starts
late on a loaded host, so :func:`robust_distributed_initialize` gives
``init_process_group`` an explicit timeout and retries the transient class
of failures a bounded number of times, destroying the half-made group
between attempts.

Environment contract (the JAX package's, all optional):

- ``DAHPE_COORDINATOR`` (``host:port``), ``DAHPE_NUM_PROCESSES``,
  ``DAHPE_PROCESS_ID``: an explicit rendezvous over TCP. Unset, the group
  comes up through ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``), which is what ``torchrun`` sets.
- ``DAHPE_DIST_INIT_TIMEOUT``: seconds for the rendezvous and for every
  collective (default 300).
- ``DAHPE_DIST_INIT_RETRIES``: attempts on a transient failure (default 3).
- ``DAHPE_DIST_BACKEND``: the backend; by default ``nccl`` for a ``cuda``
  device and ``gloo`` for ``cpu``. ``gloo`` on ``cuda`` lets several ranks
  share one card (NCCL refuses two ranks on one device); its collectives
  cannot be captured in a CUDA graph.

A rank's device is ``cuda:{local_rank % device_count}``, picked after the
group is up. The local rank and the number of ranks on this host are
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where the launcher sets both
(``torchrun``); else the ranks exchange their host names and count those
that share this one, so the ``DAHPE_*`` contract needs no per-host numbering.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

# Substrings of the transient bring-up failures (coordinator not listening
# yet, slow host): retried. Anything else re-raises at once.
_TRANSIENT = (
    "timeout",
    "timed out",
    "deadline",
    "connect",
    "unavailable",
    "connection refused",
)


_THIS_DEVICE = [torch.device("cpu")]  # set by robust_distributed_initialize


def _is_transient(err: BaseException) -> bool:
    msg = str(err).lower()
    return any(s in msg for s in _TRANSIENT)


def backend_for(device) -> str:
    """The backend a run on ``device`` uses: ``DAHPE_DIST_BACKEND``, else
    ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``."""
    return os.environ.get("DAHPE_DIST_BACKEND") or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")


def planned_world_size() -> int:
    """The world size the environment asks for, read before bring-up."""
    return int(os.environ.get("DAHPE_NUM_PROCESSES") or os.environ.get("WORLD_SIZE") or 1)


def _rendezvous() -> dict:
    if os.environ.get("DAHPE_COORDINATOR"):
        return dict(init_method=f"tcp://{os.environ['DAHPE_COORDINATOR']}",
                    world_size=int(os.environ["DAHPE_NUM_PROCESSES"]),
                    rank=int(os.environ["DAHPE_PROCESS_ID"]))
    return dict(init_method="env://")


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=int(os.environ.get("DAHPE_DIST_INIT_TIMEOUT", "300")))


def local_place(hostnames: list[str], rank: int) -> tuple[int, int]:
    """``(local rank, local size)`` of rank ``rank`` among the ranks whose
    host name (``hostnames``, one a rank in rank order) is its own."""
    mine = hostnames[rank]
    return sum(h == mine for h in hostnames[:rank]), hostnames.count(mine)


def local_rank_and_size() -> tuple[int, int]:
    """This rank's place among the ranks on its host: the launcher's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where it set both, else from the
    host names every rank reports (a collective: every rank calls it). A
    world of one, or no group, is ``(0, 1)``."""
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    world = world_size()
    if world == 1:
        return 0, 1
    # the names travel over gloo: an NCCL group needs each rank's card,
    # which is what this picks
    gloo = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo",
                                                                    timeout=_timeout())
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname(), group=gloo)
    if gloo is not None:
        dist.destroy_process_group(gloo)
    return local_place(names, rank())


def rank_device(device, local_rank: int = 0, local_size: int = 1) -> torch.device:
    """This rank's device for a run on ``device``: the CPU as it is, a card
    as ``cuda:{local_rank % device_count}``. Under NCCL every rank on this
    host (``local_size`` of them) needs a card of its own."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a cuda run needs a CUDA device; this host has none")
    if backend_for(device) == "nccl" and count < local_size:
        raise RuntimeError(
            f"{local_size} ranks on this host but {count} CUDA device(s): NCCL refuses two "
            "ranks on one device; start at most one rank per card, or set "
            "DAHPE_DIST_BACKEND=gloo to share a card")
    return torch.device("cuda", local_rank % count)


def robust_distributed_initialize(device="cuda", *, verbose: bool = True) -> torch.device:
    """``init_process_group`` with an explicit timeout and bounded retry, on
    the backend of ``device``; returns this rank's device (a card is made
    the current device). Reads the environment contract of the module
    docstring. Raises the last error when every attempt fails; a group that
    is already up is kept."""
    if not dist.is_initialized():
        _initialize(backend_for(device), verbose)
    local = _THIS_DEVICE[0] = rank_device(device, *local_rank_and_size())
    if local.type == "cuda":
        torch.cuda.set_device(local)
    return local


def _initialize(backend: str, verbose: bool) -> None:
    attempts = max(1, int(os.environ.get("DAHPE_DIST_INIT_RETRIES", "3")))
    for attempt in range(attempts):
        try:
            dist.init_process_group(backend=backend, timeout=_timeout(), **_rendezvous())
            return
        except Exception as err:
            if not _is_transient(err) or attempt == attempts - 1:
                raise
            # a failed attempt can leave a half-made group: destroy it before
            # dialing again
            shutdown()
            delay = 2.0 * (attempt + 1)
            if verbose:
                print(f"init_process_group attempt {attempt + 1}/{attempts} failed ({err}); "
                      f"retrying in {delay:.0f}s", flush=True)
            time.sleep(delay)


def this_device() -> torch.device:
    """The device :func:`robust_distributed_initialize` gave this rank
    (the CPU before it ran)."""
    return _THIS_DEVICE[0]


def rank(group=None) -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def barrier(group=None) -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier(group)


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def collective_device(group=None) -> torch.device:
    """Where a host value must lie for a collective of ``group``: the
    current card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fold_in(seed: int, rank: int) -> int:
    """A seed for rank ``rank``'s stream of ``seed`` (JAX's
    ``random.fold_in`` in spirit: distinct ranks, distinct streams)."""
    return int(np.random.SeedSequence((int(seed), int(rank))).generate_state(1, np.uint64)[0])
