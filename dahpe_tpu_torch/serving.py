"""Deployment: ahead-of-time export of the serving program with ``torch.export``.

Port of ``dahpe_tpu/serving.py``. The fused forward-plus-decode program
(images → image-space keypoint coordinates + confidences, the function of
:func:`dahpe_tpu_torch.evaluate.make_predict_fn`) is exported through
``torch.export`` and saved as one file: reloading it needs torch alone, no
model code, no checkpoint code. Weights are runtime inputs, as in the JAX
package, so one artifact serves many checkpoints: the float program takes
the serving weights (:func:`serving_weights`) as a dict of tensors, the int8
program the quantized tree of :mod:`dahpe_tpu_torch.quant`. Their companion
``.weights.npz`` files are written and read with numpy alone.

Exports can be batch-polymorphic (``batch_size=None``): one artifact serves
any batch. The artifact records its kind, device, batch, frame shape and
input dtype in the saved archive (``Artifact.meta``); an exported
program bakes its device in, so loading it on another device type raises,
and loading it for another card of its type moves it there.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from dahpe_tpu_torch import resolve_device, set_float32_policy
from dahpe_tpu_torch.core.layout import from_bkhw, to_bkhw
from dahpe_tpu_torch.evaluate import PredictProgram
from dahpe_tpu_torch.quant import make_int8_predict_fn, map_tree, to_torch

META_FILE = "dahpe_artifact.json"
MAX_BATCH = 4096  # the symbolic batch's upper bound
_SERVING_MODULES = ("backbone", "upsampling", "head")


def serving_weights(model_or_state_dict) -> dict[str, torch.Tensor]:
    """The tensors the serving forward reads: the backbone, the upsampling
    and the main head of the state dict (the adversarial heads are not on
    the serving path)."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items() if k.split(".", 1)[0] in _SERVING_MODULES}


class _ServingNet(torch.nn.Module):
    """Backbone → upsampling → main head of a ``PoseResNet`` or
    ``MultiHeadPoseResNet``, NHWC in and out: the modules and order of
    ``evaluate._eval_forward``."""

    def __init__(self, model):
        super().__init__()
        self.backbone, self.upsampling, self.head = model.backbone, model.upsampling, model.head

    def forward(self, x):
        return from_bkhw(self.head(self.upsampling(self.backbone(to_bkhw(x)))))


def _export(program: torch.nn.Module, weights, *, batch_size, image_size, input_dtype,
            device, meta) -> bytes:
    b = 2 if batch_size is None else batch_size
    x = torch.zeros((b, image_size, image_size, 3), dtype=input_dtype, device=device)
    batch_dim = None if batch_size is not None else {
        0: torch.export.Dim("batch", min=1, max=MAX_BATCH)}
    dynamic = (map_tree(lambda _: None, weights), batch_dim)
    # size-oblivious tracing: without it the tracer specializes the batch
    # away from 1 (a guard "2 <= batch"), and a 1-frame request could not run
    with torch.fx.experimental._config.patch(backed_size_oblivious=True):
        exported = torch.export.export(program, (weights, x), dynamic_shapes=dynamic)
    exported.example_inputs = None  # else the archive would carry the example weights
    meta = dict(meta, device=str(torch.device(device)), batch=batch_size,
                frame_shape=[image_size, image_size, 3], dtype=str(input_dtype).split(".")[-1],
                image_size=image_size)
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def export_predict(model, weights=None, *, batch_size: int | None = None,
                   image_size: int = 256, heatmap_size: int = 64,
                   input_dtype=torch.float32, uint8_input: bool = False,
                   device=None) -> bytes:
    """Serialize the serving program of ``model`` (its structure; its
    weights are not in the artifact) for ``device`` (default ``cuda``).

    The exported program keeps the ``(weights, images) -> (coords,
    maxvals)`` signature, ``weights`` being :func:`serving_weights` (the
    default, of ``model``'s own state). ``batch_size=None`` exports a
    symbolic batch dimension. ``uint8_input=True`` exports the raw-frame
    variant: uint8 HWC in, ImageNet normalization compiled in.
    """
    device = resolve_device(device)
    weights = serving_weights(model if weights is None else weights)
    weights = {k: v.detach().to(device) for k, v in weights.items()}
    net = _ServingNet(model)
    was_training = model.training
    model.eval()
    try:
        program = PredictProgram(
            lambda w, x: torch.func.functional_call(net, w, (x,), strict=True),
            image_size=image_size, heatmap_size=heatmap_size, uint8_input=uint8_input,
            device=device)
        return _export(program, weights, batch_size=batch_size, image_size=image_size,
                       input_dtype=torch.uint8 if uint8_input else input_dtype,
                       device=device, meta={"kind": "float", "heatmap_size": heatmap_size})
    finally:
        model.train(was_training)


def export_predict_int8(quantized, *, batch_size: int | None = None,
                        image_size: int = 256, heatmap_size: int = 64,
                        uint8_input: bool = False, glue: str = "bfloat16",
                        device=None) -> bytes:
    """Serialize the int8 serving program (``dahpe_tpu_torch/quant.py``):
    the same contract as :func:`export_predict`, its first input the
    quantized tree (``quant.to_torch`` of ``quant.quantize_model``'s
    output). ``glue`` (``"bfloat16"`` or ``"float32"``) is the inter-conv
    activation dtype (``quant.apply_int8``)."""
    device = resolve_device(device)
    program = make_int8_predict_fn(image_size=image_size, heatmap_size=heatmap_size,
                                   uint8_input=uint8_input, glue=getattr(torch, glue),
                                   device=device)
    quantized = to_torch(quantized, device)
    return _export(program, quantized, batch_size=batch_size, image_size=image_size,
                   input_dtype=torch.uint8 if uint8_input else torch.float32, device=device,
                   meta={"kind": "int8", "heatmap_size": heatmap_size, "glue": glue})


class Artifact:
    """A loaded serving artifact: ``artifact(weights, images) -> (coords (B,
    K, 2), maxvals (B, K, 1))``; ``meta`` holds what the export recorded. The
    frames must match the recorded shape and dtype (and the batch, for a
    fixed-batch export), and lie on the artifact's device."""

    def __init__(self, program, meta: dict):
        self.meta = meta
        self.module = program.module()
        self.dtype = getattr(torch, meta["dtype"])
        self.frame_shape = tuple(meta["frame_shape"])

    def __call__(self, weights, images: torch.Tensor):
        if images.dtype != self.dtype or tuple(images.shape[1:]) != self.frame_shape:
            raise ValueError(f"artifact takes (B, {', '.join(map(str, self.frame_shape))}) "
                             f"{self.meta['dtype']} frames, got {tuple(images.shape)} "
                             f"{images.dtype}")
        batch = self.meta["batch"]
        if batch is not None and images.shape[0] != batch:
            raise ValueError(f"artifact was exported for batch {batch}, got {images.shape[0]}")
        with torch.no_grad():
            return self.module(weights, images)


def load_predict(blob: bytes, *, device=None) -> Artifact:
    """Rebuild the serving callable from :func:`export_predict` (or
    :func:`export_predict_int8`) bytes, for ``device`` (default ``cuda``):
    an artifact exported for another device type raises. Sets the float32
    policy (no TF32), as the live entry points do."""
    device = resolve_device(device)
    set_float32_policy()
    extra = {META_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    if not extra[META_FILE]:
        raise ValueError("not a dahpe_tpu_torch serving artifact (no metadata)")
    meta = json.loads(extra[META_FILE])
    if torch.device(meta["device"]).type != device.type:
        raise ValueError(f"artifact was exported for {meta['device']}; it cannot run on "
                         f"{device} (export it there with --device {device.type})")
    if device.index is not None and device != torch.device(meta["device"]):
        # another card of the same type: the program's constants and the
        # devices its operations name move there
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
        meta = dict(meta, device=str(device))
    return Artifact(program, meta)


class MeshPredict:
    """Data-parallel serving over local ``devices``: ``mesh(weights, images)
    -> (coords, maxvals)`` splits the batch into one equal chunk per device,
    runs each chunk through that device's copy of the predict program
    (``predicts``, one a device, each placed there: an artifact loaded with
    ``load_predict_file(path, device=d)``, a ``PredictProgram`` made with
    ``device=d``) on that device's copy of the weights, and gathers the
    coordinates and confidences on the first device. The weights are copied
    to each device once per weights object. Rows are independent in the
    forward, so the coordinates equal one device's bit for bit (the JAX
    package's ``make_mesh_predict``: batch sharded, weights replicated).
    The batch must divide by the number of devices; the server pads to
    such a batch, and drives the same split and gather around one CUDA graph
    a device."""

    def __init__(self, predicts, devices):
        self.devices = [torch.device(d) for d in devices]
        self.predicts = list(predicts)
        if len(self.predicts) != len(self.devices):
            raise ValueError(f"{len(self.predicts)} predict programs for "
                             f"{len(self.devices)} devices")
        self._placed = (None, None)  # (weights, one copy a device)

    def weights_on(self, weights) -> list:
        """``weights`` on each device, in device order."""
        if self._placed[0] is not weights:
            self._placed = (weights, [to_torch(weights, d) for d in self.devices])
        return self._placed[1]

    def split(self, images) -> list:
        """One equal chunk of the rows of ``images`` (a tensor or an array)
        a device, in device order."""
        n = len(self.devices)
        if images.shape[0] % n:
            raise ValueError(f"a batch of {images.shape[0]} does not split over {n} devices")
        rows = images.shape[0] // n
        return [images[i * rows:(i + 1) * rows] for i in range(n)]

    def gather(self, outs) -> tuple:
        """Each device's ``(coords, maxvals)``, concatenated on the first."""
        return tuple(torch.cat([o[i].to(self.devices[0]) for o in outs]) for i in range(2))

    def __call__(self, weights, images):
        return self.gather([predict(w, chunk.to(d)) for predict, w, chunk, d in zip(
            self.predicts, self.weights_on(weights), self.split(images), self.devices)])


def make_mesh_predict(predicts, devices) -> MeshPredict:
    """:class:`MeshPredict` over ``devices``, ``predicts`` one program a
    device."""
    return MeshPredict(predicts, devices)


def save_predict(path: str, model, **kw) -> None:
    with open(path, "wb") as f:
        f.write(export_predict(model, **kw))


def load_predict_file(path: str, *, device=None) -> Artifact:
    with open(path, "rb") as f:
        return load_predict(f.read(), device=device)


def _flat_keys(tree, prefix=()):
    """``("a/0/wq", leaf)`` pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        yield "/".join(prefix), tree
        return
    for k, v in items:
        yield from _flat_keys(v, prefix + (str(k),))


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_variables_npz(path: str, weights) -> None:
    """Companion weight file of a float artifact: a plain ``.npz`` keyed by
    state-dict key, loadable with numpy alone. ``np.savez`` is slow on a
    checkpoint's hot path but right here: export runs once and the single
    file is the deployment contract."""
    np.savez(path, **{k: _numpy(v) for k, v in serving_weights(weights).items()})


def save_quantized_npz(path: str, quantized) -> None:
    """Weight file of an int8 artifact: the quantized tree (which nests
    lists: layers, blocks, head stages) flattened to ``a/0/b`` keys; its
    int8 weights make it ~4x smaller than the float file."""
    np.savez(path, **{k: _numpy(v) for k, v in _flat_keys(quantized)})


def load_quantized_npz(path: str) -> dict:
    """Rebuild the quantized tree (CPU tensors) from
    :func:`save_quantized_npz` output: all-digit key levels become lists
    again, restoring the ``layers``/``up``/``head`` sequences."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(np.array(data[key]))

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(out)


def load_variables_npz(path: str) -> dict[str, torch.Tensor]:
    """The serving weights (CPU tensors) from :func:`save_variables_npz`."""
    with np.load(path) as data:
        return {k: torch.from_numpy(np.array(data[k])) for k in data.files}


def load_artifact_weights(path: str):
    """Load the ``.weights.npz`` sibling of an exported artifact, float or
    int8 alike: quantized trees are recognized by their per-conv int8
    weight leaves (``.../wq``)."""
    with np.load(path) as data:
        quantized = any(k == "wq" or k.endswith("/wq") for k in data.files)
    return load_quantized_npz(path) if quantized else load_variables_npz(path)
