"""Run logger: directories, checkpoint/image paths, console tee, metrics.

Port of ``dahpe_tpu/utils/logging.py``: the same directories, console log
and ``metrics.jsonl`` records (``kind`` and keys). In a data-parallel run
only rank 0 logs (``primary=False`` elsewhere: no directories, no console
file, no records).

Equivalent of ``CompleteLogger`` (``utils/logger.py:5-98``) minus the
stdout/stderr hijack — output is *tee'd* to ``{log}/{phase}-{time}.txt``
instead of redirected, so the console stays live. Beyond the reference it
also appends structured scalars to ``{log}/metrics.jsonl``
(:meth:`RunLogger.log_metrics`) so dashboards/analysis never have to
re-parse the console text (the soak/drill experiments do, and it is
fragile by construction).
"""

from __future__ import annotations

import json
import os
import sys
import time


class _Tee:
    def __init__(self, stream, fh):
        self.stream = stream
        self.fh = fh

    def write(self, msg):
        self.stream.write(msg)
        self.fh.write(msg)

    def flush(self):
        self.stream.flush()
        self.fh.flush()


class RunLogger:
    def __init__(self, root: str, phase: str = "train", tee: bool = True,
                 primary: bool = True):
        self.root = root
        self.phase = phase
        self.primary = primary
        self.visualize_directory = os.path.join(root, "visualize")
        self.checkpoint_directory = os.path.join(root, "checkpoints")
        self.epoch = 0
        self._fh = None
        if not primary:
            return
        os.makedirs(self.root, exist_ok=True)
        os.makedirs(self.visualize_directory, exist_ok=True)
        os.makedirs(self.checkpoint_directory, exist_ok=True)
        if tee:
            now = time.strftime("%Y-%m-%d-%H_%M_%S", time.localtime())
            log_filename = f"{phase}-{now}.txt"
            self._fh = open(os.path.join(root, log_filename), "w")
            self._stdout, self._stderr = sys.stdout, sys.stderr
            sys.stdout = _Tee(self._stdout, self._fh)
            sys.stderr = _Tee(self._stderr, self._fh)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if not self.primary:
            return
        os.makedirs(os.path.join(self.visualize_directory, str(epoch)), exist_ok=True)

    def get_checkpoint_path(self, name=None) -> str:
        if name is None:
            name = self.epoch
        return os.path.join(self.checkpoint_directory, str(name))

    def get_image_path(self, filename: str) -> str:
        if self.phase == "train":
            return os.path.join(
                self.visualize_directory, str(self.epoch), filename
            )
        return os.path.join(self.visualize_directory, filename)

    def log_metrics(self, **scalars) -> None:
        """Append one JSON line of run metrics to ``{log}/metrics.jsonl``.

        Values are coerced through ``float()`` where possible (numpy and
        0-d tensor scalars included); dict values (per-group PCK tables) are
        coerced per entry. Appending keeps the file valid across ``--resume``
        processes — consumers see one monotone stream keyed by ``step``.
        """
        if not self.primary:
            return

        def coerce(v):
            if isinstance(v, dict):
                return {k: coerce(x) for k, x in v.items()}
            try:
                return float(v)
            except (TypeError, ValueError):
                return v

        record = {"time": round(time.time(), 3), "phase": self.phase}
        record.update({k: coerce(v) for k, v in scalars.items()})
        with open(os.path.join(self.root, "metrics.jsonl"), "a") as fh:
            fh.write(json.dumps(record) + "\n")

    def close(self):
        if self._fh is not None:
            sys.stdout = self._stdout
            sys.stderr = self._stderr
            self._fh.close()
            self._fh = None
