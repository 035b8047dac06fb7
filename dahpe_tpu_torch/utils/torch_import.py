"""Weight carrier: ``dahpe_tpu`` Flax variables → this port's state dict.

The port's modules are named after the reference's torch state-dict keys,
the same keys the JAX package's Flax modules are named after, so moving
weights is a mechanical transform (the port's own copy of the logic of
``dahpe_tpu/utils/torch_import.py:export_torch_state_dict``):

- conv ``kernel (kh, kw, I, O)``           → ``weight (O, I, kh, kw)``
- deconv ``kernel`` (flipped forward-conv HWIO) → ``weight (I, O, kh, kw)``
- BN params ``scale/bias``                 → ``weight/bias``
- BN batch_stats ``mean/var``              → ``running_mean/running_var``
- ``layerL_B`` / ``downsample_N``          → ``layerL.B`` / ``downsample.N``

The input is a ``{"params", "batch_stats"}`` tree of arrays (numpy, or
anything ``numpy.asarray`` accepts); nothing of JAX is imported here.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], object]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _is_deconv(mod: tuple[str, ...]) -> bool:
    return "upsampling" in mod


def _torch_key(mod: tuple[str, ...], leaf: str) -> str:
    parts = []
    for p in mod:
        if "_" in p and (p.startswith("layer") or p.startswith("downsample")):
            head, tail = p.rsplit("_", 1)
            if tail.isdigit():
                parts.extend([head, tail])
                continue
        parts.append(p)
    return ".".join(parts + [leaf])


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Convert the JAX package's ``{"params", "batch_stats"}`` tree into a
    state dict that ``load_state_dict`` of the port's model accepts."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})).items():
        mod, leaf = path[:-1], path[-1]
        v = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if _is_deconv(mod):
                w = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif v.ndim == 4:
                w = v.transpose(3, 2, 0, 1)
            else:
                w = v.T
            out[_torch_key(mod, "weight")] = torch.from_numpy(np.ascontiguousarray(w))
        elif leaf == "scale":
            out[_torch_key(mod, "weight")] = torch.from_numpy(v.copy())
        elif leaf == "bias":
            out[_torch_key(mod, "bias")] = torch.from_numpy(v.copy())
        else:
            raise ValueError(f"unhandled param {'/'.join(path)!r}")
    names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        mod, leaf = path[:-1], path[-1]
        if leaf not in names:
            raise ValueError(f"unhandled batch stat {'/'.join(path)!r}")
        out[_torch_key(mod, names[leaf])] = torch.from_numpy(
            np.asarray(value, dtype=np.float32).copy()
        )
        out.setdefault(_torch_key(mod, "num_batches_tracked"),
                       torch.tensor(0, dtype=torch.long))
    return out


def load_pth(path: str, key: str | None = "model") -> dict[str, torch.Tensor]:
    """Read a reference torch ``.pth`` file → its state dict on the CPU.

    Reference training checkpoints store the model under ``"model"``; raw
    torchvision ImageNet files are bare state dicts (pass ``key=None``).
    Those checkpoints pickle more than tensors, so the file is unpickled in
    full: load only files from a trusted source.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and isinstance(obj, dict) and key in obj:
        obj = obj[key]
    return {k: v.detach() for k, v in obj.items()}
