"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The kernel and compiler caches live in fixed
directories under ``build/`` of the checkout, so only the first run of a
cell there builds. See :mod:`portbench.harness`.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_compute")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(t_start=T_START))
