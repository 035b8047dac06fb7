"""Build and load the port's CUDA kernels as C-ABI shared libraries.

Each library is compiled with ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``dahpe_tpu_torch/csrc/`` at its first use and loaded with
``ctypes``. The file name carries the sha256 of the sources and the flags, so
an edited source builds a new library and a stale one is never loaded. The
compiler writes to a temporary name that ``os.replace`` moves into place, so
concurrent processes never see a half-written library.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> (CDLL, build record); one load per process
_loaded: dict[str, tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _start(name: str, sources: list[str]):
    """``(lib_path, None)`` if the library is built, else ``(lib_path, job)``
    with its ``nvcc`` running in the background."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{_digest(paths)}.so")
    if os.path.exists(lib_path):
        return lib_path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return lib_path, (proc, cmd, tmp, time.perf_counter())


def _finish(name: str, lib_path: str, job) -> dict:
    """Wait for a build that :func:`_start` began; move it into place."""
    if job is None:
        return {"built": False, "seconds": 0.0, "log": ""}
    proc, cmd, tmp, t0 = job
    stdout, stderr = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{stdout}\n{stderr}"
        )
    os.replace(tmp, lib_path)
    return {"built": True, "seconds": seconds, "log": (stdout + stderr).strip()}


def build(name: str, sources: list[str]) -> tuple[str, dict]:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``build/kernels/lib<name>-<hash>.so`` unless that file exists.

    Returns the library path and a record of the build: whether it ran, its
    seconds, and ``nvcc``'s register/shared-memory report.
    """
    lib_path, job = _start(name, sources)
    return lib_path, _finish(name, lib_path, job)


def load(name: str, sources: list[str]) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``sources`` at first use."""
    if name not in _loaded:
        path, record = build(name, sources)
        _loaded[name] = (ctypes.CDLL(path), record)
    return _loaded[name][0]


def load_all(libraries: dict[str, list[str]]) -> None:
    """Load every library of ``{name: sources}``, building the missing ones
    with one ``nvcc`` each, all started together."""
    jobs = {name: _start(name, sources)
            for name, sources in libraries.items() if name not in _loaded}
    for name, (lib_path, job) in jobs.items():
        record = _finish(name, lib_path, job)
        _loaded[name] = (ctypes.CDLL(lib_path), record)


def build_record(name: str) -> dict:
    """What :func:`build` reported for the library ``name`` in this process."""
    return _loaded[name][1]
