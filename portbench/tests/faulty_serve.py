"""``portbench/serve_shim.py`` with a fault planted in the server where it
produces its answers, for the fault tests:

    python3 portbench/tests/faulty_serve.py <altered|half> <serve_shim arguments>

``altered`` moves the first row's first keypoint of every dispatch by two
heatmap cells; ``half`` computes only the first half of each dispatch's
rows and answers the rest with theirs."""

import os
import runpy
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dahpe_tpu_torch.cli import serve  # noqa: E402

fault = sys.argv.pop(1)
whole = serve._Servable.run_arrays


def altered(self, frames):
    coords, maxvals = whole(self, frames)
    coords = coords.copy()
    coords[0, 0, 0] += 8.0
    return coords, maxvals


def half(self, frames):
    n = frames.shape[0]
    h = max(1, n // 2)
    coords, maxvals = whole(self, frames[:h])
    reps = -(-n // h)
    return np.concatenate([coords] * reps)[:n], np.concatenate([maxvals] * reps)[:n]


serve._Servable.run_arrays = {"altered": altered, "half": half}[fault]
shim = os.path.join(ROOT, "portbench", "serve_shim.py")
sys.argv[0] = shim
runpy.run_path(shim, run_name="__main__")
