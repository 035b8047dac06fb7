"""Client for the ``dahpe_tpu_torch.cli.serve`` HTTP endpoint — the standard
library and numpy only (no torch).

The port's copy of ``dahpe_tpu/client.py``: the two packages' servers speak
one protocol (docs/SERVING.md), deliberately minimal: ``GET
/healthz`` for the artifact geometry, ``POST /predict`` with an ``.npy``
body of frames, JSON keypoints back. This module wraps it in a typed
client so deployment code never hand-rolls the wire format::

    from dahpe_tpu_torch.client import PoseClient

    client = PoseClient("127.0.0.1", 8000)
    client.health()                     # {'batch': 96, 'dtype': 'uint8', ...}
    coords, maxvals = client.predict(frames)   # (B,K,2) px, (B,K) conf

``frames`` is an ``(B, H, W, 3)`` numpy array matching the artifact's
input contract (uint8 for ``--uint8-input`` exports, float32 otherwise);
the server replies 400/413 on contract violations, surfaced here as
:class:`ServeError` with the server's message. The connection is kept
alive across calls (one TCP + TLS-less handshake per client, not per
frame batch).
"""

from __future__ import annotations

import io
import json
from http.client import HTTPConnection

import numpy as np


class ServeError(RuntimeError):
    """A non-200 reply from the serving endpoint (the server's own error
    message, e.g. a shape/dtype contract violation or an over-batch 413)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class PoseClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000, *,
                 timeout: float = 120.0):
        self._conn = HTTPConnection(host, port, timeout=timeout)

    def _json(self, resp) -> dict:
        raw = resp.read()
        try:
            body = json.loads(raw)
        except ValueError:
            # replies produced outside the endpoint's JSON path (stdlib
            # send_error HTML, a proxy's error page) still surface as the
            # documented ServeError, never a JSONDecodeError
            body = None
        if resp.status != 200:
            message = (body.get("error", str(body))
                       if isinstance(body, dict)
                       else raw.decode("utf-8", "replace")[:200])
            raise ServeError(resp.status, message)
        if not isinstance(body, dict):
            raise ServeError(
                resp.status, f"non-JSON 200 reply: {raw[:200]!r}"
            )
        return body

    def health(self) -> dict:
        """Artifact geometry + server counters: ``batch`` (None =
        batch-polymorphic), ``frame_shape``, ``dtype``, ``devices``,
        ``requests``/``batches`` (the live dynamic-batching ratio)."""
        self._conn.request("GET", "/healthz")
        info = self._json(self._conn.getresponse())
        if info["batch"] is not None:
            info["batch"] = int(info["batch"])
        return info

    def predict(self, frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Keypoints for ``(B, H, W, 3)`` frames: ``(coords (B,K,2) in image
        pixels, maxvals (B,K) confidences)``."""
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(frames))
        self._conn.request("POST", "/predict", body=buf.getvalue())
        out = self._json(self._conn.getresponse())
        return (
            np.asarray(out["coords"], np.float32),
            np.asarray(out["maxvals"], np.float32),
        )

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "PoseClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
