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
:func:`da_state_from_jax` carries a whole DA training state the same way:
weights, BN statistics, the per-partition momentum, the step and the EMA, so
a port run continues a JAX run mid-training.
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


def filtered_update(state_dict: Mapping, imported: Mapping) -> dict[str, torch.Tensor]:
    """``state_dict`` with every entry of ``imported`` whose key and shape
    it has replaced: the reference's key-filtered, ``strict=False`` warm
    start (``train1.py:184-189``), as the JAX package's ``filtered_update``.
    The pretrain head's Conv1x1 keys, absent from the multi-head model, are
    dropped."""
    out = dict(state_dict)
    for key, value in imported.items():
        if key in out and tuple(out[key].shape) == tuple(value.shape):
            out[key] = torch.as_tensor(value)
    return out


def _momentum_trace(opt_state) -> Mapping:
    """The trace tree of one partition's optax state: ``torch_sgd`` is
    ``chain(add_decayed_weights, trace)``, whose state is a tuple holding a
    ``TraceState(trace=...)``."""
    for part in opt_state:
        if hasattr(part, "trace"):
            return part.trace
    raise ValueError(f"no momentum trace in optimizer state {type(opt_state).__name__}")


def da_state_from_jax(state, model: torch.nn.Module, *, device=None, momentum: float = 0.9,
                      weight_decay: float = 1e-4):
    """Carry a ``dahpe_tpu`` ``DATrainState`` (its leaves as numpy arrays)
    into the port: ``model`` gets its params and BN stats, each partition's
    SGD its optax ``trace`` as ``momentum_buffer``, and the returned
    :class:`~dahpe_tpu_torch.train.da.DATrainState` its step and EMA.
    ``model`` must be the port's counterpart of the JAX model."""
    from dahpe_tpu_torch.train.da import create_da_state

    model.load_state_dict(state_dict_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    out = create_da_state(model, device=device, with_ema=state.ema_params is not None,
                          momentum=momentum, weight_decay=weight_decay)
    out.step = int(np.asarray(state.step))
    named = dict(model.named_parameters())
    for name, opt_state in state.opt.items():
        buffers = state_dict_from_jax({"params": _momentum_trace(opt_state)})
        opt = out.optimizers[name]
        owned = {id(p) for group in opt.param_groups for p in group["params"]}
        if {id(named[k]) for k in buffers} != owned:
            raise ValueError(f"momentum of partition {name!r} does not cover its parameters")
        for key, value in buffers.items():
            p = named[key]
            opt.state[p]["momentum_buffer"] = value.to(p.device)
    if out.ema is not None:
        ema = state_dict_from_jax(
            {"params": state.ema_params, "batch_stats": state.ema_batch_stats})
        with torch.no_grad():
            for key, value in out.ema.items():
                value.copy_(ema[key])
    return out
