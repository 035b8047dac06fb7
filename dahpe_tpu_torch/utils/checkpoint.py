"""Checkpointing: packed training state, plus reference-``.pth`` interop.

Port of ``dahpe_tpu/utils/checkpoint.py``. A training state is saved whole
in the packed format (:mod:`dahpe_tpu_torch.utils.fast_ckpt`) as the tree

    model/<state-dict key>       parameters, BN statistics, BN counters
    opt/<partition>/<param key>  each SGD's momentum buffer (zeros where a
                                 partition has not been stepped yet; torch's
                                 first step then gives the same buffer)
    step                         the host step count
    ema/<state-dict key>         the EMA entries (DA state with --with-ema)

and a model alone (``pretrain``, ``best``'s EMA twin) as ``model/...``.
:func:`load_model_variables` reads those and the JAX package's packed
checkpoints (``params/...``, ``batch_stats/...``). The sidecar
``<path>_aux.npz`` holds the sampling generators' states and the best-PCK
watermark. ``.pth`` files use the reference's torch key space as they are.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from dahpe_tpu_torch.utils import fast_ckpt


def host_array(v) -> np.ndarray:
    """A tensor, generator state or number as a numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _param_names(model: torch.nn.Module) -> dict[int, str]:
    return {id(p): name for name, p in model.named_parameters()}


def state_tree(state) -> dict:
    """The checkpoint tree of a ``DATrainState`` or ``PretrainState``: live
    tensors (the packer copies them) and the step as a 0-d tensor."""
    model = state.model
    names = _param_names(model)
    opt = {}
    for part, optimizer in state.optimizers.items():
        opt[part] = {}
        for group in optimizer.param_groups:
            for p in group["params"]:
                buf = optimizer.state.get(p, {}).get("momentum_buffer")
                opt[part][names[id(p)]] = torch.zeros_like(p) if buf is None else buf
    device = next(model.parameters()).device
    tree = {"model": dict(model.state_dict()), "opt": opt,
            "step": torch.tensor(state.step, dtype=torch.int64, device=device)}
    if getattr(state, "ema", None) is not None:
        tree["ema"] = dict(state.ema)
    return tree


def model_tree(model_or_state_dict) -> dict:
    """The checkpoint tree of a model alone (``model/<key>``)."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return {"model": dict(sd)}


def save_state(path: str, state) -> None:
    """Save a training state now (packed, overwriting)."""
    fast_ckpt.save_packed(path, state_tree(state))


def restore_state(path: str, state):
    """Restore ``path`` into ``state`` in place (model, momentum, step, EMA)
    and return it. The checkpoint must hold exactly the state's tree."""
    tree = fast_ckpt.restore_packed(path, state_tree(state))
    model = state.model
    with torch.no_grad():
        model.load_state_dict(tree["model"])
        params = dict(model.named_parameters())
        for part, optimizer in state.optimizers.items():
            for key, buf in tree["opt"][part].items():
                # in place where the buffer exists: a captured iteration
                # (train/fused.py) keeps updating the tensors it recorded
                held = optimizer.state[params[key]].get("momentum_buffer")
                if held is None:
                    optimizer.state[params[key]]["momentum_buffer"] = buf.clone()
                else:
                    held.copy_(buf)
        if "ema" in tree:
            for key, value in state.ema.items():
                value.copy_(tree["ema"][key])
    state.step = int(tree["step"])
    return state


def save_aux(path: str, **arrays) -> None:
    """Sidecar ``<path>_aux.npz``: the sampling generators' states
    (``key_s``/``key_t``) and the best-PCK watermark. Without them a resumed
    run would replay its sampling from the start and could overwrite
    ``best`` with a worse epoch. Written atomically (tmp + ``os.replace``)."""
    final = path + "_aux.npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{k: host_array(v) for k, v in arrays.items() if v is not None})
    os.replace(tmp, final)


def load_aux(path: str) -> dict:
    """The sidecar arrays of :func:`save_aux`; ``{}`` when absent or
    unreadable (the resume then seeds fresh streams from the step)."""
    f = path + "_aux.npz"
    if not os.path.exists(f):
        return {}
    try:
        with np.load(f) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # truncated/corrupt zip: degrade, don't die
        print(f"warning: ignoring unreadable resume sidecar {f}: {e}")
        return {}


def prune_epoch_checkpoints(checkpoint_dir: str, keep: int) -> list[int]:
    """Delete all but the newest ``keep`` integer-named (per-epoch)
    checkpoints under ``checkpoint_dir`` and their sidecars; named ones
    (``best``, ``model_ema``, ``pretrain`` ...) are never touched. Returns
    the pruned epoch numbers."""
    if keep <= 0:
        return []
    epochs = sorted(
        int(name) for name in os.listdir(checkpoint_dir)
        if name.isdigit() and os.path.isdir(os.path.join(checkpoint_dir, name))
    )
    pruned = epochs[:-keep] if keep < len(epochs) else []
    for epoch in pruned:
        shutil.rmtree(os.path.join(checkpoint_dir, str(epoch)))
        aux = os.path.join(checkpoint_dir, f"{epoch}_aux.npz")
        if os.path.exists(aux):
            os.remove(aux)
    return pruned


def load_model_variables(path: str) -> dict[str, torch.Tensor]:
    """The model's state dict (CPU tensors) from a packed checkpoint with no
    template: the port's (``model/...``, a full state or a model alone) or
    the JAX package's (``params``/``batch_stats``, carried by
    :func:`~dahpe_tpu_torch.utils.torch_import.state_dict_from_jax`)."""
    from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax

    path = os.path.abspath(path)
    if not fast_ckpt.resolve_packed(path):
        raise ValueError(f"{path}: not a packed checkpoint (legacy orbax directories "
                         "of the JAX package are read by the JAX package only)")
    tree = fast_ckpt.load_packed_tree(path)
    if "model" in tree:
        return dict(tree["model"])
    if "params" in tree:
        return state_dict_from_jax({"params": tree["params"],
                                    "batch_stats": tree.get("batch_stats", {})})
    raise ValueError(f"{path}: neither a port nor a JAX-package checkpoint "
                     f"(top-level keys {sorted(tree)})")


def save_reference_pth(path: str, model_or_state_dict) -> None:
    """Write a torch ``{'model': state_dict}`` .pth that the reference loads
    (the port's keys are the reference's; nothing is transposed)."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    torch.save({"model": {k: v.detach().cpu() for k, v in sd.items()}}, path)


def load_reference_pth(path: str, model: torch.nn.Module, *, strict: bool = False) -> None:
    """Load a reference ``.pth`` into ``model``. ``strict=True`` requires
    every key and shape to match (evaluating a published checkpoint);
    ``strict=False`` is the reference's key-filtered warm start
    (``train1.py:184-189``)."""
    from dahpe_tpu_torch.utils.torch_import import filtered_update, load_pth

    sd = load_pth(path)
    if not strict:
        sd = filtered_update(model.state_dict(), sd)
    model.load_state_dict(sd)


def load_imagenet_backbone(path: str, model: torch.nn.Module) -> None:
    """Load a torchvision ImageNet ``.pth`` (a bare state dict with an
    ``fc`` classifier) into ``model.backbone``, key-filtered
    (``uda/model/resnet.py:50-59``)."""
    from dahpe_tpu_torch.utils.torch_import import filtered_update, load_pth

    sd = {"backbone." + k: v for k, v in load_pth(path, key=None).items()
          if not k.startswith("fc.")}
    model.load_state_dict(filtered_update(model.state_dict(), sd))
